"""Corpus construction: the padded bag-of-words layout and the synthetic
paper-shaped corpora."""
