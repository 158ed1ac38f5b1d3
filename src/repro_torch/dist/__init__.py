"""Distributed D-IVI: only its configuration is ported so far
(`protocol.DIVIConfig`); the engine is ROADMAP §1 item 6."""
from repro_torch.dist.protocol import DIVIConfig, not_ported

__all__ = ["DIVIConfig", "not_ported"]
