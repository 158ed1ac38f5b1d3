"""setup_s: seconds from the run's first line to the window's start
(imports, the kernel library's load or build, the corpus, the program's
state and the traffic's own fill and warm-up)."""


def read(rec):
    return rec.get("setup_s")
