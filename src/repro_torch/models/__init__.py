"""The LM template's models (``repro.models``): the attention blocks."""
