"""FakeQuantized training of the ssm (falcon_mamba_7b) and hybrid
(zamba2_1_2b) families in the port, against the JAX reference.

Held here (reduced falcon_mamba_7b: 2 Mamba-1 layers, d 128; zamba2_1_2b
cut to 4 layers on both sides, `dataclasses.replace(cfg.reduced(),
n_layers=4)`: two groups of two Mamba-2 blocks, each followed by the one
shared attention, whose gradient sums over both applications; batch 4
x 64 tokens):

  - `loss_fn` at Rep.FQ against the reference jitted and run op by op
    (`jax.disable_jit()`): the loss and every gradient leaf within 1.5x
    the reference's own jit-vs-op-by-op gap on the same batch, against
    both runs; and the FP loss held the same way.  The port's scan
    island is the reference's fused serving programs (`core.island`:
    the combine's multiply-add fused, the h . C contraction as fused
    lanes), which neither reference run computes exactly; its loss lies
    nearer the op-by-op run's (asserted);
  - the scan cores' gradients (`ssm_core`, `ssm2_core`) against jax's
    of the reference's `_core_fp` over two chunks (L 256, the chunk
    rematerialisation), and their forward bits with gradients on equal
    to the serving bits;
  - the qstate layout of every new family (`init_qstate` against the
    reference's `plan()`: {} a mamba or hybrid segment, the MoE's
    stacked clips), the trainer's trajectory for falcon_mamba_7b under
    `test_torch_train._same_trajectory`, a crash restart that resumes
    bit for bit, checkpoints of both families crossing to the
    reference's tree and back, and the CLI.

MEASURED (on the CPU, this batch): falcon_mamba_7b's loss is within
1.3e-6 relative of the op-by-op reference's and 3.6e-5 of the jitted
one's (their own gap 3.5e-5), its worst gradient leaf within 1.14x the
gap (x_proj); zamba2_1_2b's loss within 1.3e-6 and 4.7e-5 (gap
4.8e-5), its worst leaf within 1.35x the gap (A_log: 2.5e-2 against
1.9e-2).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import manager as j_ckpt
from repro.configs.base import get_config as j_get_config
from repro.core.rep import Rep as JRep
from repro.data.synthetic import SyntheticConfig, SyntheticStream
from repro.launch.steps import build_train_step as j_build_train_step
from repro.launch import variants as j_variants
from repro.launch.train import build as j_build
from repro.layers.ssm import QMamba1 as JQMamba1
from repro.layers.ssm import QMamba2 as JQMamba2
from repro.models.lm import DecoderLM as JLM
from repro.optim.adamw import adamw_init as j_adamw_init
from repro_torch.checkpoint import manager as ckpt
from repro_torch.configs.base import get_config
from repro_torch.core.rep import Rep
from repro_torch.core.tree import tree_leaves
from repro_torch.launch import variants
from repro_torch.launch.elastic import TrainSupervisor
from repro_torch.launch.steps import build_train_step, value_and_grad
from repro_torch.launch.train import build, main as train_main
from repro_torch.layers.ssm import ssm2_core, ssm_core
from repro_torch.models.lm import DecoderLM, params_to_torch
from repro_torch.optim.adamw import adamw_init
from test_torch_train import _rel_l2, _same_trajectory
from test_torch_train_moe import _within_gap, check_against_both_runs

SEQ, BATCH, STEPS = 64, 4, 10
HYBRID_LAYERS = 4


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The reduced models' products are too small for torch's thread
    pool, which only contends with XLA's and the other test workers'."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a))


def _reference(arch, seq=SEQ, batch=BATCH):
    """-> (jlm, jtr, port lm, the batch stream): the reference's train
    state as `launch.train.build` makes it (PRNGKey 0), zamba2 cut to
    HYBRID_LAYERS on both sides."""
    if arch == "falcon_mamba_7b":
        jlm, jtr, _, _, stream = j_build(arch, reduced=True, seq=seq,
                                         batch=batch)
        lm = build(arch, reduced=True, seq=seq, batch=batch,
                   device="cpu")[0]
        return jlm, jtr, lm, stream
    cfg = dataclasses.replace(j_get_config(arch).reduced(),
                              n_layers=HYBRID_LAYERS)
    jlm = JLM(cfg, max_seq=seq + 1)
    jtr = {"params": jlm.init(jax.random.PRNGKey(0)),
           "qstate": jlm.init_qstate()}
    lm = build(arch, reduced=True, seq=seq, batch=batch, device="cpu",
               n_layers=HYBRID_LAYERS)[0]
    stream = SyntheticStream(SyntheticConfig(vocab=cfg.vocab, seq_len=seq,
                                             global_batch=batch))
    return jlm, jtr, lm, stream


_RUNS = {}
# the bf16 island's cell: two chunks of 128 a sequence
BF16_SEQ, BF16_BATCH = 256, 2


def _runs(arch, bf16=False):
    """The FQ value and gradient jitted, op by op and on the port, and
    the FP loss of each, on batch 0 (once a module); with `bf16`, under
    ``ssm_island_dtype="bf16"`` on both sides at BF16_SEQ tokens."""
    if (arch, bf16) in _RUNS:
        return _RUNS[arch, bf16]
    if bf16:
        with j_variants.use_variants(ssm_island_dtype="bf16"), \
                variants.use_variants(ssm_island_dtype="bf16"):
            _RUNS[arch, bf16] = _runs_on(
                *_reference(arch, BF16_SEQ, BF16_BATCH))
    else:
        _RUNS[arch, bf16] = _runs_on(*_reference(arch))
    return _RUNS[arch, bf16]


def _runs_on(jlm, jtr, lm, stream):
    tok = stream.batch(0)
    tr = params_to_torch(_np(jtr), "cpu")

    def jloss(rep):
        return lambda t: jlm.loss_fn(t["params"], t["qstate"],
                                     jnp.asarray(tok), rep)

    def tloss(rep):
        return lambda t, x: lm.loss_fn(t["params"], t["qstate"], x, rep)

    out = {"jlm": jlm, "jtr": jtr, "lm": lm, "stream": stream, "tr": tr}
    out["jit"] = jax.jit(jax.value_and_grad(jloss(JRep.FQ)))(jtr)
    out["jit_fp"] = float(jax.jit(jloss(JRep.FP))(jtr))
    with jax.disable_jit():
        out["eager"] = jax.value_and_grad(jloss(JRep.FQ))(jtr)
        out["eager_fp"] = float(jloss(JRep.FP)(jtr))
    out["port"] = value_and_grad(tloss(Rep.FQ), tr, _t(tok))
    with torch.no_grad():
        out["port_fp"] = float(tloss(Rep.FP)(tr, _t(tok)))
    return out


ARCHS = ["falcon_mamba_7b", "zamba2_1_2b"]


@pytest.mark.parametrize("arch", ARCHS)
def test_fq_loss_and_gradients_within_the_reference_gap(arch):
    r = _runs(arch)
    leaves = tree_leaves(r["port"][1])
    assert len(leaves) == len(jax.tree.leaves(r["jit"][1])) == (
        13 if arch == "falcon_mamba_7b" else 17)
    check_against_both_runs(r["jit"], r["eager"], r["port"])
    jl, el, tl = (float(r[k][0]) for k in ("jit", "eager", "port"))
    assert abs(tl - el) < abs(tl - jl)   # nearer the op-by-op run


@pytest.mark.parametrize("arch", ARCHS)
def test_fp_loss_within_the_reference_gap(arch):
    r = _runs(arch)
    _within_gap(r["jit_fp"], r["eager_fp"], r["port_fp"], "fp loss")


def test_shared_attention_gradient_sums_over_its_applications():
    """zamba2's one shared weight set gets the gradient of both its
    applications: no leaf of it is zero, and it matches the reference's
    (held within the gap above)."""
    r = _runs("zamba2_1_2b")
    assert r["lm"].groups == 2
    g = r["port"][1]["params"]["shared_attn"]
    for leaf in tree_leaves(g):
        assert float(leaf.abs().sum()) > 0


# -- the scan cores ----------------------------------------------------------
def _scan_inputs(mamba2: bool, L: int = 256):
    rng = np.random.default_rng(11)
    B = 2
    if mamba2:
        H, P, ds = 4, 8, 16
        x = rng.standard_normal((B, L, H, P)).astype(np.float32)
        dt = np.log1p(np.exp(rng.standard_normal((B, L, H)) - 3.0))
        A = -np.linspace(1.0, 16.0, H).astype(np.float32)
        D = np.ones((H,), np.float32)
    else:
        di, ds = 16, 16
        x = rng.standard_normal((B, L, di)).astype(np.float32)
        dt = np.log1p(np.exp(rng.standard_normal((B, L, di)) - 3.0))
        A = -np.broadcast_to(np.arange(1, ds + 1, dtype=np.float32),
                             (di, ds)).copy()
        D = np.ones((di,), np.float32)
    bm = rng.standard_normal((B, L, ds)).astype(np.float32)
    cm = rng.standard_normal((B, L, ds)).astype(np.float32)
    return [x, dt.astype(np.float32), bm, cm, A, D]


@pytest.mark.parametrize("mamba2", [False, True])
def test_scan_core_gradients_equal_reference(mamba2):
    """Two chunks of 128 (each rematerialised): y and h_last bit for bit
    with and without gradients, and each input's gradient within 1e-5
    relative L2 of jax's of the reference's `_core_fp` (jitted; the
    port's fused multiply-adds and the flushed subnormals are where the
    two may round apart)."""
    args = _scan_inputs(mamba2)
    if mamba2:
        layer = JQMamba2(32, d_state=16, expand=1, head_dim=8)

        def jcore(x, dt, bm, cm, A, D):
            return layer._core_fp(x, dt, bm[:, :, None], cm[:, :, None], A,
                                  D)
        tcore = ssm2_core
    else:
        layer = JQMamba1(8, d_state=16)

        def jcore(x, dt, bm, cm, A, D):
            return layer._core_fp(x, dt, bm, cm, A, D, return_h=True)
        tcore = ssm_core
    rng = np.random.default_rng(12)
    (y, h), vjp = jax.vjp(jax.jit(jcore), *map(jnp.asarray, args))
    gy = rng.standard_normal(y.shape).astype(np.float32)
    gh = rng.standard_normal(h.shape).astype(np.float32)
    jgrads = vjp((jnp.asarray(gy), jnp.asarray(gh)))
    ts = [_t(a).requires_grad_() for a in args]
    ty, th = tcore(*ts)
    with torch.no_grad():
        ny, nh = tcore(*map(_t, args))
    assert torch.equal(ty.detach(), ny) and torch.equal(th.detach(), nh)
    np.testing.assert_allclose(ny.numpy(), np.asarray(y), rtol=1e-5,
                               atol=1e-5 * float(np.abs(y).max()))
    tgrads = torch.autograd.grad((ty, th), ts, (_t(gy), _t(gh)))
    for name, a, b in zip("x dt B C A D".split(), jgrads, tgrads):
        assert _rel_l2(a, b.numpy()) <= 1e-5, name


# -- the layout, the trainer, checkpoints, the CLI ------------------------
@pytest.mark.parametrize("arch,layers", [
    ("olmoe_1b_7b", None), ("falcon_mamba_7b", None),
    ("zamba2_1_2b", None), ("zamba2_1_2b", HYBRID_LAYERS)])
def test_qstate_layout_equals_reference(arch, layers):
    jcfg, cfg = j_get_config(arch).reduced(), get_config(arch).reduced()
    if layers:
        jcfg = dataclasses.replace(jcfg, n_layers=layers)
        cfg = dataclasses.replace(cfg, n_layers=layers)
    want = JLM(jcfg, max_seq=SEQ).init_qstate()
    got = DecoderLM(cfg, max_seq=SEQ).init_qstate("cpu")
    assert jax.tree.structure(want) == jax.tree.structure(
        jax.tree.map(np.asarray, got, is_leaf=torch.is_tensor))
    for a, b in zip(jax.tree.leaves(want), tree_leaves(got)):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


def test_bf16_island_raises_on_training():
    """The bf16 island trains: reduced falcon_mamba_7b at two chunks of
    128 under ``ssm_island_dtype="bf16"`` on both sides, the FQ loss and
    every gradient leaf within 1.5x the reference's own jit-vs-op-by-op
    gap, and the loss apart from the float32 island's on the same
    batch.  The name is kept on purpose from when the port refused the
    variant (it pinned that refusal), so the test's history stays
    whole; it now checks the opposite."""
    r = _runs("falcon_mamba_7b", bf16=True)
    check_against_both_runs(r["jit"], r["eager"], r["port"])
    tl = r["lm"].loss_fn(r["tr"]["params"], r["tr"]["qstate"],
                         _t(r["stream"].batch(0)), Rep.FQ)
    assert float(tl) != float(r["port"][0])


def test_bf16_island_fq_within_the_reference_gap_zamba2():
    """As above for zamba2_1_2b cut to HYBRID_LAYERS (its Mamba-2
    blocks' bf16 chunks, the shared attention in float)."""
    r = _runs("zamba2_1_2b", bf16=True)
    check_against_both_runs(r["jit"], r["eager"], r["port"])


def _trajectory(step, tr, opt, batches):
    losses = []
    for b in batches:
        loss, tr, opt = step(tr, opt, b)
        losses.append(float(loss))
    return losses


@pytest.fixture(scope="module")
def falcon():
    jlm, jtr, jopt, jstep, stream = j_build("falcon_mamba_7b", reduced=True,
                                            seq=SEQ, batch=BATCH)
    _, _, _, step, _ = build("falcon_mamba_7b", reduced=True, seq=SEQ,
                             batch=BATCH, device="cpu")
    return {"jtr": jtr, "jopt": jopt, "jstep": jstep, "stream": stream,
            "step": step, "tr": params_to_torch(_np(jtr), "cpu")}


def test_trainer_trajectory_equals_reference(falcon):
    g = falcon
    want = _trajectory(g["jstep"], g["jtr"], g["jopt"], [
        jnp.asarray(g["stream"].batch(s)) for s in range(STEPS)])
    got = _trajectory(g["step"], g["tr"], adamw_init(g["tr"]), [
        _t(g["stream"].batch(s)) for s in range(STEPS)])
    _same_trajectory(want, got)


def test_crash_restart_resumes_bit_for_bit(tmp_path, falcon):
    g = falcon

    def sup(path, **kw):
        return TrainSupervisor(
            train_step=g["step"], make_batch=lambda s: _t(
                g["stream"].batch(s)), ckpt_dir=str(path), **kw)

    tr0, opt0 = g["tr"], adamw_init(g["tr"])
    with pytest.raises(RuntimeError, match="injected node failure"):
        sup(tmp_path / "a", ckpt_every=2, fail_at=5).run(tr0, opt0,
                                                        n_steps=6)
    assert ckpt.latest_step(tmp_path / "a") == 4
    out = sup(tmp_path / "a", ckpt_every=2).run(tr0, opt0, n_steps=6)
    assert out["status"] == "done" and len(out["losses"]) == 2
    ref = sup(tmp_path / "b", ckpt_every=100).run(tr0, opt0, n_steps=6)
    assert out["losses"] == ref["losses"][4:]


@pytest.mark.parametrize("arch", ARCHS)
def test_checkpoints_interchange_with_the_reference(tmp_path, arch):
    """A step of each side's train step, saved, restores into the other
    side's tree leaf for leaf (empty qstate segments included)."""
    r = _runs(arch)
    jtr, tr = r["jtr"], r["tr"]
    tok = r["stream"].batch(1)
    jopt = j_adamw_init(jtr)
    _, jtr1, jopt1 = jax.jit(j_build_train_step(r["jlm"]))(
        jtr, jopt, {"tokens": jnp.asarray(tok)})
    j_ckpt.save(tmp_path / "j", 1, {"trainable": jtr1, "opt": jopt1})
    got = ckpt.restore(tmp_path / "j", 1,
                       {"trainable": tr, "opt": adamw_init(tr)})
    want = jax.tree.leaves({"trainable": jtr1, "opt": jopt1})
    assert len(want) == len(tree_leaves(got))
    for a, b in zip(want, tree_leaves(got)):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    _, tr1, opt1 = build_train_step(r["lm"])(tr, adamw_init(tr),
                                             {"tokens": _t(tok)})
    ckpt.save(tmp_path / "t", 1, {"trainable": tr1, "opt": opt1})
    back = j_ckpt.restore(tmp_path / "t", 1,
                          {"trainable": jtr, "opt": jopt})
    for a, b in zip(jax.tree.leaves(back), tree_leaves(
            {"trainable": tr1, "opt": opt1})):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize("arch", ARCHS)
def test_train_cli_on_the_cpu(tmp_path, capsys, arch):
    out = train_main(["--arch", arch, "--reduced", "--device", "cpu",
                      "--steps", "2", "--batch", "2", "--seq", "16",
                      "--ckpt", str(tmp_path)])
    assert out["status"] == "done" and ckpt.latest_step(tmp_path) == 2
    assert all(np.isfinite(out["losses"]))
    assert "status=done step=2" in capsys.readouterr().out
