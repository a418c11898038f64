"""PyTorch/CUDA port of the integer-only (NEMO ID) serving path.

`repro_torch` mirrors the layout of the JAX reference package `repro`
(core/ configs/ layers/ models/ kernels/ serving/ launch/) with the
same module and class names, so each port module sits at the path of
its counterpart.  It imports only `torch` and `numpy`.

Transform-time code (deploy, requant scheduling, LUT building) stays
host-side numpy; the integer runtime runs on torch tensors.  Every
runtime entry point takes a `device`, which defaults to ``"cuda"``.
On a CUDA tensor the three hand-written kernels (kernels/) carry the
int8 GEMMs, the standalone requantizations and the paged attention;
on a CPU tensor each kernel wrapper runs its plain PyTorch version
instead, which is how the CPU tests hold the port against `repro`.
"""
