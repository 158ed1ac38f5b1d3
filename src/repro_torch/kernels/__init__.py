"""Hand-written CUDA kernels of the E-step (``csrc/``), their checked
wrappers and plain twins (`lda_estep`), the build (`build`) and the E-step
entry points over them (`ops`)."""
