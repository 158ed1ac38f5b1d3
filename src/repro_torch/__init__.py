"""PyTorch / CUDA port of ``repro``: incremental variational inference for
LDA (Algorithm 1) on an NVIDIA H100.

The module paths mirror ``repro`` so each piece sits beside its
counterpart. The package imports ``torch`` and numpy only; its hot path runs
in hand-written CUDA C++ kernels (`repro_torch.kernels`). Entry points run
on ``"cuda"`` unless the caller passes ``device="cpu"``.
"""
