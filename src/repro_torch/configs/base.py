"""Architecture configuration schema + registry (port of
`repro.configs.base`, cut to what the dense and MoE serving paths
read).

Registered: the token configs of the reference that the port serves,
one file each with its values: `granite_3_2b`, `llama3_2_3b` and
`chatglm3_6b` (RMSNorm, gated SiLU MLP), `musicgen_medium` (LayerNorm
with bias, ungated GELU MLP, MHA), `nemotron_4_340b` (LayerNorm with
bias, ungated squared-ReLU MLP, head_dim 192), `olmoe_1b_7b` (the
MoE family: 64 experts, top-8, an expert layer in every block),
`llama4_maverick_400b_a17b` (128 experts, top-1, an expert layer in
every other block with a shared expert beside it), `falcon_mamba_7b`
(the ssm family: 64 Mamba-1 blocks, no attention),
`zamba2_1_2b` (the hybrid family: Mamba-2 blocks and one shared
attention block over concat(x, x0) applied every 6 of them),
`internvl2_76b` (a dense backbone fed int8 embedding rows, input_mode
"embeds": no embedding table; `SERVE_ARCH_IDS`, the serving CLI's
--arch, leaves it out, as the reference's engine refuses it); and
`nemo_cnn`, the paper's CNN (family "cnn", served by
`models.cnn.NemoCNN`; `LM_ARCH_IDS` leaves it out, as the reference's
dry run does).
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict

_REGISTRY: Dict[str, "ArchConfig"] = {}

ARCH_IDS = ["granite_3_2b", "llama3_2_3b", "chatglm3_6b", "musicgen_medium",
            "nemotron_4_340b", "olmoe_1b_7b", "llama4_maverick_400b_a17b",
            "falcon_mamba_7b", "zamba2_1_2b", "internvl2_76b", "nemo_cnn"]
# the configs `DecoderLM` runs
LM_ARCH_IDS = [a for a in ARCH_IDS if a != "nemo_cnn"]
# the token LMs the serving engine takes (the serving CLI's --arch)
SERVE_ARCH_IDS = [a for a in LM_ARCH_IDS if a != "internvl2_76b"]


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                 # dense | moe | ssm | hybrid | cnn
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
    # --- MoE ---
    n_experts: int = 0
    top_k: int = 1
    moe_every: int = 1          # 2 = MoE on every other layer (llama4)
    shared_expert: bool = False
    moe_group: int = 512
    # --- SSM ---
    ssm_kind: str = ""          # mamba1 | mamba2
    ssm_state: int = 16
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    # --- hybrid (zamba2) ---
    shared_attn_every: int = 0
    input_mode: str = "tokens"  # tokens | embeds (a frontend's int8 rows)
    sub_quadratic: bool = False  # eligible for long contexts
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
        `reduced()`)."""
        kw = dataclasses.asdict(self)
        kw.update(
            n_layers=min(self.n_layers, 2 if self.shared_attn_every == 0
                         else self.shared_attn_every + 1),
            d_model=128,
            vocab=256,
            d_ff=256 if self.d_ff else 0,
            n_heads=4 if self.n_heads else 0,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads else 0,
            head_dim=32 if self.n_heads else 0,
            n_experts=min(self.n_experts, 4),
            top_k=min(self.top_k, 2),
            moe_group=64,
            ssm_state=min(self.ssm_state, 16),
            ssm_head_dim=(
                32 if self.ssm_kind == "mamba2" else self.ssm_head_dim),
            shared_attn_every=2 if self.shared_attn_every else 0,
            name=self.name + "_reduced",
        )
        return ArchConfig(**kw)

    def param_count(self) -> int:
        """Analytic parameter count (the reference's)."""
        if self.family not in ("dense", "moe", "ssm", "hybrid"):
            raise NotImplementedError(
                f"param_count of the {self.family} family")
        d, V, hd = self.d_model, self.vocab, self.hd
        ff_mats = 3 if self.gated else 2
        n = 2 * V * d  # embed + head
        if self.family == "ssm":
            di = self.ssm_expand * d
            rank = max(1, -(-d // 16))
            per_layer = (d * 2 * di + di * (rank + 2 * self.ssm_state)
                         + rank * di + di * d + di * self.ssm_state
                         + 2 * di + d)
            return int(n + self.n_layers * per_layer)
        if self.family == "hybrid":
            di = self.ssm_expand * d
            H = di // self.ssm_head_dim
            per_layer = (d * (2 * di + 2 * self.ssm_state + H) + di * d
                         + 3 * H + 2 * di + d)
            n += self.n_layers * per_layer
            if self.shared_attn_every:
                n += (2 * d * (self.n_heads + 2 * self.n_kv_heads) * hd
                      + self.n_heads * hd * d)
            return int(n)
        for i in range(self.n_layers):
            n += (d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd
                  + self.n_heads * hd * d) + 2 * d  # attention, norms
            if self.n_experts > 0 and (
                    i % self.moe_every == self.moe_every - 1):
                n += self.n_experts * ff_mats * d * self.d_ff
                n += d * self.n_experts  # router
                if self.shared_expert:
                    n += ff_mats * d * self.d_ff
            else:
                n += ff_mats * d * self.d_ff
        return int(n)

    def active_param_count(self) -> int:
        """Active params per token (MoE: routed top-k + shared only)."""
        if self.n_experts == 0:
            return self.param_count()
        ff_mats = 3 if self.gated else 2
        L_moe = self.n_layers // self.moe_every
        return int(self.param_count() - (self.n_experts - self.top_k)
                   * ff_mats * self.d_model * self.d_ff * L_moe)


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
