"""Hand-written Hopper kernels, each with its plain PyTorch version
beside it (see build.py for how they are built).

  int8_matmul          csrc/int8_matmul.cu      every QLinear (int8/int32 out)
  int8_matmul_grouped  csrc/int8_matmul.cu      the MoE's expert GEMMs: all
                                                G x E groups in one launch;
                                                the write-then-gather
                                                attention's two products
                                                (scores, P.V; int32 out,
                                                one group a slot and kv
                                                head), and the blockwise
                                                attention's, a key block
                                                at a time
  requant              csrc/requant.cu          the standalone requant sites:
                                                ctx_rqt (heads to rows), each
                                                QAdd, the gated MLP's LUT,
                                                gate product and h_rqt, the
                                                ungated MLP's activation
  paged_attention      csrc/paged_attention.cu  unified paged ID attention,
                                                int8 pools
  paged_attention_kv4  csrc/paged_attention.cu  the same, int4-packed pools
                                                (kv_bits 4)
  quant_flash_attention  csrc/quant_attention.cu  blockwise quantized flash
                                                attention (its own entry
                                                point; no serving path)

A wrapper runs its plain version only for CPU tensors; for a CUDA
tensor it launches its kernel or raises.  Each wrapper counts its
launches in a plain integer attribute (`int8_matmul.launches`, ...);
`paged_attention` counts a launch over packed pools on the counter
`paged_attention_kv4.launches` instead; `int8_matmul.by_shape` splits
the GEMM's count by (M, K, N, output type), `int8_matmul_grouped.by_shape`
the grouped form's by (groups, C, K, N, output type) (the attention's
products under (B * K, group * S, hd, T, "int32") and (B * K, group *
S, T padded to 16, hd, "int32")), and
`requant.by_form` the
requant's by call form (`requant`, `requant_add`, `requant_gate` and
`requant_act` all count on `requant.launches`).
"""
from repro_torch.kernels.int8_matmul import (
    int8_matmul, int8_matmul_grouped, int8_matmul_grouped_plain,
    int8_matmul_plain,
)
from repro_torch.kernels.paged_attention import (
    paged_attention, paged_attention_kv4, paged_attention_plain,
)
from repro_torch.kernels.quant_attention import (
    quant_flash_attention, quant_flash_attention_plain,
)
from repro_torch.kernels.requant_kernel import (
    requant, requant_act, requant_act_plain, requant_add, requant_add_plain,
    requant_gate, requant_gate_plain, requant_plain,
)

KERNELS = {
    "int8_matmul": int8_matmul,
    "int8_matmul_grouped": int8_matmul_grouped,
    "requant": requant,
    "paged_attention": paged_attention,
    "paged_attention_kv4": paged_attention_kv4,
    "quant_flash_attention": quant_flash_attention,
}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0
    int8_matmul.by_shape = {}
    int8_matmul_grouped.by_shape = {}
    requant.by_form = {}


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in KERNELS.items()}
