"""Core datatypes for incremental variational inference for LDA.

The corpus is held in the padded bag-of-words layout: each document is a row
of *unique* token ids plus their counts, padded to the corpus-wide maximum
number of unique tokens per document, with padding marked by count 0.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names one.

    There is no silent CPU fallback: with no ``device`` and no CUDA the
    call raises, so a run that was meant for the card never measures the
    CPU by accident.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass "
                               "device='cpu' to run on the CPU")
        return torch.device("cuda")
    return torch.device(device)


@dataclasses.dataclass(frozen=True)
class Corpus:
    """Padded bag-of-words corpus.

    Attributes:
      token_ids: ``(D, L)`` int32 unique token ids per document, padded
        with 0. Padding is disambiguated by ``counts == 0``.
      counts: ``(D, L)`` float32 occurrence counts; 0 on padding.
    """

    token_ids: torch.Tensor
    counts: torch.Tensor

    @property
    def num_docs(self) -> int:
        return self.token_ids.shape[0]

    @property
    def max_unique(self) -> int:
        return self.token_ids.shape[1]

    @property
    def num_words(self) -> torch.Tensor:
        return self.counts.sum()

    def to(self, device) -> "Corpus":
        return Corpus(self.token_ids.to(device), self.counts.to(device))


@dataclasses.dataclass(frozen=True)
class KernelPolicy:
    """Policy of the CUDA E-step kernels (`repro_torch.tune` searches it).

    Every field defaults to what the kernels chose before the tuner
    existed, so ``KernelPolicy()`` and a ``None`` policy launch the same
    kernels with the same bits.

    * ``block_b`` — the fixed point's stopping tile: each tile of
      ``block_b`` documents stops on its own mean |Δγ|, exactly as the TPU
      kernel's B-tile did, so the default (128, as in ``repro``) keeps γ
      and the per-tile sweep counts comparable with the Pallas kernel.
    * ``wire_dtype`` — ``repro``'s advisory memo wire ("float32" or
      "bfloat16") recorded by the tuner; the memo store still decides the
      wire.
    * ``double_buffer_depth`` — the staging queue of
      ``TopicInferencer.posterior_docs`` (``repro``'s meaning and default).

    The launch of each kernel (warps per document, grid, ids a warp)
    stays the kernel's own choice: the card showed no other launch that
    keeps the bits and is faster (ROADMAP, item 8).
    """

    block_b: int = 128
    wire_dtype: Optional[str] = None
    double_buffer_depth: int = 2


#: The policy in effect when none is configured.
DEFAULT_KERNEL_POLICY = KernelPolicy()


@dataclasses.dataclass(frozen=True)
class LDAConfig:
    """Hyper-parameters; defaults are the paper's §6 experimental setup."""

    num_topics: int = 100
    vocab_size: int = 10_000
    alpha0: float = 0.5          # document-topic Dirichlet prior
    beta0: float = 0.05          # topic-word Dirichlet prior
    kappa: float = 0.9           # learning-rate decay (S-IVI)
    tau: float = 1.0             # learning-rate delay
    estep_max_iters: int = 100   # cap on the local fixed point
    estep_tol: float = 1e-4      # mean-abs-change convergence threshold
    estep_backend: str = "gather"  # "gather" | "dense" | "cuda" | "csr"
    # dtype the cuda fixed point streams Eφ in: "float32" or "bfloat16"
    # (Eφ, and on the padded layout the counts, rounded through bf16, fp32
    # arithmetic; π and the scatter stay fp32), as repro's pallas backend
    estep_stream_dtype: str = "float32"
    kernel_policy: Optional[KernelPolicy] = None

    def rho(self, t):
        """Robbins–Monro step size ρ_t = (t + τ)^(−κ)."""
        return (t + self.tau) ** (-self.kappa)


@dataclasses.dataclass
class GlobalState:
    """Global variational state.

    ``lam`` is the (V, K) topic-word Dirichlet parameter; ``m_vk`` the
    sufficient-statistic accumulator ⟨m_vk⟩; ``t`` counts global updates.
    ``init_mass``/``init_frac`` carry the random-initialisation mass of
    Alg. 1 line 1: each document's pro-rata share is retired on its first
    visit, so after one full pass λ = β₀ + ⟨m_vk⟩ holds exactly (eq. 4).
    """

    lam: torch.Tensor          # (V, K) float32
    m_vk: torch.Tensor         # (V, K) float32
    init_mass: torch.Tensor    # (V, K) float32
    init_frac: torch.Tensor    # () float32
    t: torch.Tensor            # () int32


@dataclasses.dataclass
class Memo:
    """Per-document memoized responsibilities, token-aligned: the raw dense
    pair the engines' ``DenseMemoStore`` wraps, and what ``ivi_step`` /
    ``sivi_step`` take.

    ``pi`` is (D, L, K), π for each (document, unique-token) slot, zero on
    padding; ``visited`` (D,) marks documents whose memo counts in ⟨m_vk⟩.
    """

    pi: torch.Tensor           # (D, L, K) float32
    visited: torch.Tensor      # (D,) bool


def init_memo(cfg: "LDAConfig", num_docs: int, max_unique: int, *,
              device=None) -> Memo:
    """A zero memo with nothing visited."""
    device = resolve_device(device)
    return Memo(pi=torch.zeros((num_docs, max_unique, cfg.num_topics),
                               dtype=torch.float32, device=device),
                visited=torch.zeros((num_docs,), dtype=torch.bool,
                                    device=device))


def _standard_gamma(shape: float, size, generator: torch.Generator
                    ) -> torch.Tensor:
    """Gamma(shape, 1) draws for shape ≥ 1 (Marsaglia & Tsang 2000).

    ``torch.distributions`` takes no generator, so the draw is written out
    on the generator's device; rejected entries are redrawn.
    """
    d = shape - 1.0 / 3.0
    c = 1.0 / (9.0 * d) ** 0.5
    dev = generator.device
    out = torch.empty(size, dtype=torch.float32, device=dev)
    todo = torch.ones(size, dtype=torch.bool, device=dev)
    while bool(todo.any()):
        x = torch.randn(size, generator=generator, device=dev)
        u = torch.rand(size, generator=generator, device=dev)
        v = (1.0 + c * x) ** 3
        ok = (v > 0) & (torch.log(u) < 0.5 * x * x + d - d * v
                        + d * torch.log(v.clamp_min(1e-30)))
        take = todo & ok
        out[take] = (d * v)[take]
        todo &= ~ok
    return out


def init_global_state(cfg: LDAConfig, *, device=None,
                      generator: Optional[torch.Generator] = None,
                      lam0=None) -> GlobalState:
    """Random λ initialisation (Algorithm 1, line 1): Gamma(100, 0.01).

    ``jax.random.gamma`` cannot be reproduced in torch, so ``lam0`` (a
    (V, K) array or tensor) injects λ₀ — that is how the parity tests start
    both packages from the same point. Without it λ₀ is drawn from
    ``generator`` (seed 0 on ``device`` when none is given).
    """
    device = resolve_device(device)
    if lam0 is None:
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(0)
        lam0 = _standard_gamma(100.0, (cfg.vocab_size, cfg.num_topics),
                               generator) * 0.01
    lam = torch.as_tensor(lam0, dtype=torch.float32).to(device).clone()
    if lam.shape != (cfg.vocab_size, cfg.num_topics):
        raise ValueError(f"lam0 has shape {tuple(lam.shape)}, expected "
                         f"{(cfg.vocab_size, cfg.num_topics)}")
    return GlobalState(
        lam=lam,
        m_vk=torch.zeros_like(lam),
        init_mass=lam - cfg.beta0,
        init_frac=torch.ones((), dtype=torch.float32, device=device),
        t=torch.zeros((), dtype=torch.int32, device=device),
    )
