"""Architecture configuration schema + registry (port of
`repro.configs.base`, cut to what the dense serving path reads).

Registered: the dense configs the port serves with its layers as they
are, `granite_3_2b`, `llama3_2_3b` and `chatglm3_6b` (the reference's
values, one file each).
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict

_REGISTRY: Dict[str, "ArchConfig"] = {}

ARCH_IDS = ["granite_3_2b", "llama3_2_3b", "chatglm3_6b"]


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                 # dense (the only family the port serves)
    n_layers: int
    d_model: int
    vocab: int
    n_heads: int = 0
    n_kv_heads: int = 0
    head_dim: int = 0           # 0 -> d_model // n_heads
    d_ff: int = 0
    act: str = "silu"
    gated: bool = True
    norm: str = "rms"
    norm_bias: bool = False
    rope_base: float = 10000.0
    rope_fraction: float = 1.0
    input_mode: str = "tokens"
    notes: str = ""

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // max(self.n_heads, 1))

    @property
    def vocab_padded(self) -> int:
        """Vocab padded to 256; logits beyond `vocab` are masked."""
        return -(-self.vocab // 256) * 256

    def reduced(self) -> "ArchConfig":
        """Tiny same-family variant for CPU tests (the reference's
        `reduced()` for a dense config)."""
        kw = dataclasses.asdict(self)
        kw.update(
            n_layers=min(self.n_layers, 2),
            d_model=128,
            vocab=256,
            d_ff=256 if self.d_ff else 0,
            n_heads=4 if self.n_heads else 0,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads else 0,
            head_dim=32 if self.n_heads else 0,
            name=self.name + "_reduced",
        )
        return ArchConfig(**kw)


def register(cfg: ArchConfig) -> ArchConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ArchConfig:
    name = name.replace("-", "_").replace(".", "_")
    if name not in _REGISTRY:
        if name not in ARCH_IDS:
            raise KeyError(
                f"unknown arch {name!r}; this port registers {ARCH_IDS}")
        importlib.import_module(f"repro_torch.configs.{name}")
    return _REGISTRY[name]
