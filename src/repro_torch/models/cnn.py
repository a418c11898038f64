"""The paper's own model class (port of `repro.models.cnn.NemoCNN`): a
Conv-BN-ReLU CNN with the whole NEMO lifecycle, exercising every §3
operator:

  FP  : conv -> BN -> ReLU stacks, average pools, a linear classifier
        (`apply_float` at Rep.FP, observing each block's ranges)
  FQ  : PACT weights and activations (`apply_float` at Rep.FQ with a
        qstate; autograd follows the straight-through backward of
        `core.pact`)
  QD  : quantized BN, hardened weights, Eq. 10 activations on frozen
        quanta (`harden`, `qd_state`, `apply_qd`)
  ID  : integer tables (`deploy`), one of three BN strategies a model:
        'fold' Eq. 18, 'intbn' Eq. 21-22, 'thresh' Eq. 19-20
        (`apply_id`)

Input representation (§3.7): 8-bit images, eps_in = 1/255, zp -128
(`image_inputs`).

As a library call:

    cnn = NemoCNN()
    p = cnn.init_np(seed)                            # numpy floats
    calib = cnn.calibrate(p, x, device="cuda")       # FP forward
    t_np = cnn.deploy(p, calib, bn_mode="thresh")    # numpy tables
    t = tables_from_numpy(t_np, device="cuda")       # device state
    logits = cnn.apply_id(t, s_x)                    # int32 (B, 10)

`deploy` builds the reference's tables leaf for leaf on the host
(float64 numpy); `tables_from_numpy` lays them out for the device.  On
the card every convolution and the head run on the int8 GEMM kernel
(kernels/int8_matmul.py; 'fold' fuses each block's requant into its
epilogue) and intbn's requant on the requant kernel
(kernels/requant_kernel.py); the integer BN, the threshold count and
the average pool are integer torch ops on the device.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.bn import (
    apply_integer_bn, apply_thresholds, fold_bn, integer_bn_to_torch,
    thresholds_to_torch,
)
from repro_torch.core.calibrate import Calibrator
from repro_torch.core.pact import pact_act
from repro_torch.core.rep import Rep
from repro_torch.core.requant import make_rqt
from repro_torch.kernels.requant_kernel import requant
from repro_torch.layers.common import ACT_QMAX, ACT_QMIN
from repro_torch.layers.conv import QAvgPool2d, QBatchNorm2d, QConv2d
from repro_torch.layers.linear import QLinear, harden_weights_np
from repro_torch.models.lm import params_to_torch, tree_to_torch

BN_MODES = ("fold", "intbn", "thresh")


def _np_tree(tree):
    """A param tree of numpy arrays or torch tensors -> numpy."""
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_np_tree(v) for v in tree]
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return np.asarray(tree)


@dataclasses.dataclass(frozen=True)
class NemoCNN:
    channels: Tuple[int, ...] = (16, 32, 64)
    in_channels: int = 3
    n_classes: int = 10
    img: int = 32
    act_bits: int = 8

    def _convs(self) -> List[QConv2d]:
        cs = (self.in_channels,) + self.channels
        return [QConv2d(cs[i], cs[i + 1], kernel=3)
                for i in range(len(self.channels))]

    def _head(self) -> QLinear:
        side = self.img // (2 ** len(self.channels))
        return QLinear(
            self.channels[-1] * side * side,
            self.n_classes,
            use_bias=True,
            per_channel=False,
        )

    def init_np(self, seed: int) -> dict:
        """Float params with the reference's tree, shapes and scales
        (seeded numpy; the reference draws with jax.random, so the values
        differ); a fresh BN is the identity."""
        rng = np.random.default_rng(seed)
        p = {"blocks": []}
        for conv in self._convs():
            p["blocks"].append({"conv": conv.init_np(rng),
                                "bn": QBatchNorm2d(conv.c_out).init_np()})
        p["head"] = self._head().init_np(rng)
        return p

    def init_qstate(self) -> dict:
        return {"beta": [np.float32(6.0) for _ in self.channels]}

    # -- float paths -----------------------------------------------------
    def apply_float(self, p: dict, x: torch.Tensor, rep: Rep, *,
                    qstate: Optional[dict] = None,
                    calib: Optional[Calibrator] = None) -> torch.Tensor:
        """FP (or FQ with a qstate) forward of float32 NHWC images;
        ``p`` torch tensors on x's device (`params_to_torch`).  With a
        calibrator, each block observes its conv output (b{i}.phi) and
        its ReLU'd BN output (b{i}.act)."""
        pool = QAvgPool2d(2)
        for i, conv in enumerate(self._convs()):
            bp = p["blocks"][i]
            phi = conv.apply(bp["conv"], x, rep)
            bn = QBatchNorm2d(conv.c_out).apply_fp(bp["bn"], phi)
            if calib is not None:
                calib.observe(f"b{i}.phi", phi)
                calib.observe(f"b{i}.act", torch.clamp(bn, min=0.0))
            if rep is Rep.FQ and qstate is not None:
                x = pact_act(bn, qstate["beta"][i], self.act_bits)
            else:
                x = torch.clamp(bn, min=0.0)
            x = pool.apply_fp(x)
        x = x.reshape(x.shape[0], -1)
        return self._head().apply(p["head"], x, rep)

    def calibrate(self, p, x, *, device="cuda") -> Calibrator:
        """The FullPrecision forward of float images ``x`` (numpy or
        torch, NHWC) on `device`, observing every block's ranges."""
        calib = Calibrator()
        xt = torch.as_tensor(x, dtype=torch.float32).to(device)
        with torch.no_grad():
            self.apply_float(params_to_torch(_np_tree(p), device), xt,
                             Rep.FP, calib=calib)
        return calib

    def apply_qd(self, p: dict, dstate: dict, x: torch.Tensor,
                 trace: Optional[list] = None) -> torch.Tensor:
        """QuantizedDeployable: hardened weights (already in ``p``, torch),
        quantized BN params, Eq. 10 activations on frozen eps; real
        arithmetic.  ``trace`` collects each block's activation quanta."""
        pool = QAvgPool2d(2)
        for i, conv in enumerate(self._convs()):
            bp = p["blocks"][i]
            phi = conv.apply_fp(bp["conv"], x)
            d = {k: torch.as_tensor(np.asarray(v)).to(x.device)
                 for k, v in dstate["blocks"][i].items()}
            # quantized BN (Eq. 21): kappa/lambda on their grids
            bn = phi * d["kappa_hat"] + d["lambda_hat"]
            q = torch.clamp(torch.floor(bn / d["eps_y"]), 0,
                            2 ** self.act_bits - 1)
            if trace is not None:
                trace.append(q)
            x = pool.apply_fp(q * d["eps_y"])
        x = x.reshape(x.shape[0], -1)
        return self._head().apply_fp(p["head"], x)

    # -- transforms ------------------------------------------------------
    def harden(self, p) -> dict:
        """FQ -> QD weight hardening (net.harden_weights()), numpy."""
        p_np = _np_tree(p)
        out = {"blocks": [], "head": harden_weights_np(p_np["head"])}
        for i in range(len(self.channels)):
            bp = p_np["blocks"][i]
            w = bp["conv"]["w"]
            beta = np.maximum(
                np.abs(w).reshape(-1, w.shape[-1]).max(axis=0), 1e-8
            )
            eps_w = 2.0 * beta / 255.0
            q = np.clip(np.floor(w / eps_w), -128, 127)
            out["blocks"].append({
                "conv": {**bp["conv"], "w": (q * eps_w).astype(np.float32)},
                "bn": bp["bn"],
            })
        return out

    def qd_state(self, p, calib: Calibrator) -> dict:
        """bn_quantizer + set_deployment for the QD representation."""
        p_np = _np_tree(p)
        ds = {"blocks": []}
        for i in range(len(self.channels)):
            bn = p_np["blocks"][i]["bn"]
            kappa = bn["gamma"] / bn["sigma"]
            lam = bn["beta"] - kappa * bn["mu"]
            beta_k = np.maximum(np.abs(kappa).max(), 1e-12)
            eps_k = 2.0 * beta_k / 255.0
            kappa_hat = np.clip(np.round(kappa / eps_k), -128, 127) * eps_k
            beta_l = np.maximum(np.abs(lam).max(), 1e-12)
            eps_l = 2.0 * beta_l / 255.0
            lambda_hat = np.clip(np.round(lam / eps_l), -128, 127) * eps_l
            beta_y = calib.beta(f"b{i}.act", default=6.0)
            ds["blocks"].append({
                "kappa_hat": kappa_hat.astype(np.float32),
                "lambda_hat": lambda_hat.astype(np.float32),
                "eps_y": np.float32(beta_y / (2 ** self.act_bits - 1)),
            })
        return ds

    def deploy(
        self,
        p,
        calib: Calibrator,
        *,
        bn_mode: str = "intbn",
        factor: int = 256,
        eps_in: float = 1.0 / 255.0,
        zp_in: int = -128,
    ) -> dict:
        """-> ID tables (numpy, the reference's tree leaf for leaf).

        The deployed activation quantizer rounds to nearest rather than
        Eq. 10's floor: a transform-time half-quantum shift folded into
        the tables of every strategy (thresholds at (i - 1/2)*eps_y;
        +eps_y/2 on the folded bias and on the integer BN's lambda)."""
        if bn_mode not in BN_MODES:
            raise ValueError(f"bn_mode {bn_mode!r} not in {BN_MODES}")
        p_np = _np_tree(p)
        t = {
            "meta": {"eps_in": eps_in, "zp_in": zp_in, "bn_mode": bn_mode},
            "blocks": [],
        }
        eps_x, zp_x = eps_in, zp_in
        for i, conv in enumerate(self._convs()):
            bp = p_np["blocks"][i]
            bn = bp["bn"]
            beta_y = calib.beta(f"b{i}.act", default=6.0)
            eps_y = beta_y / (2 ** self.act_bits - 1)
            blk = {}
            if bn_mode == "fold":
                w_f, b_f = fold_bn(
                    bp["conv"]["w"], bp["conv"].get("b"), bn["gamma"],
                    bn["beta"], bn["mu"], bn["sigma"], channel_axis=-1,
                )
                cf = QConv2d(conv.c_in, conv.c_out, conv.kernel, use_bias=True)
                ip, eps_acc = cf.deploy(
                    {"w": w_f, "b": b_f + 0.5 * eps_y}, eps_x, zp_x)
                blk["conv"] = ip
                blk["rqt"] = make_rqt(
                    eps_acc, eps_y, zp_out=ACT_QMIN, qmin=ACT_QMIN,
                    qmax=ACT_QMAX, requant_factor=factor,
                    acc_bound=conv.acc_bound())
            else:
                ip, eps_acc = conv.deploy(bp["conv"], eps_x, zp_x)
                blk["conv"] = ip
                if bn_mode == "intbn":
                    ibn = QBatchNorm2d(conv.c_out).make_integer(
                        bn, eps_acc, acc_bound=conv.acc_bound())
                    half = np.round(0.5 * eps_y / ibn.eps_out)
                    ibn = dataclasses.replace(
                        ibn, q_lambda=(ibn.q_lambda + half).astype(np.int32)
                    )
                    blk["ibn"] = ibn
                    blk["rqt"] = make_rqt(
                        ibn.eps_out, eps_y, zp_out=ACT_QMIN, qmin=ACT_QMIN,
                        qmax=ACT_QMAX, requant_factor=factor,
                        acc_bound=2.0 ** 28)
                else:  # thresh: exact integer thresholds (Eq. 19-20)
                    # per-channel eps_acc -> per-channel thresholds
                    th = []
                    for ch in range(conv.c_out):
                        th_c = QBatchNorm2d(1).make_thresholds(
                            {k: bn[k][ch:ch + 1] for k in bn},
                            float(eps_acc[ch]), eps_y,
                            2 ** self.act_bits, rounded=True)
                        th.append(th_c[0])
                    blk["th"] = np.stack(th).astype(np.int64)
            t["blocks"].append(blk)
            eps_x, zp_x = eps_y, ACT_QMIN  # ReLU image: [0, 255] at zp -128
        ih, eps_logits = self._head().deploy(p_np["head"], eps_x, zp_x)
        t["head"] = ih
        t["meta"]["eps_logits"] = float(np.max(eps_logits))
        return t

    # -- integer path ----------------------------------------------------
    def apply_id(self, t: dict, s_x: torch.Tensor,
                 trace: Optional[list] = None) -> torch.Tensor:
        """int8 NHWC images -> int32 logits (B, n_classes); ``t`` from
        `tables_from_numpy` on s_x's device.  ``trace`` collects each
        block's int8 activations and each pool's output, in order."""
        pool = QAvgPool2d(2)
        mode = t["meta"]["bn_mode"]
        for i, conv in enumerate(self._convs()):
            blk = t["blocks"][i]
            if mode == "fold":
                s_y = conv.apply_id(blk["conv"], s_x, blk["rqt"])
            elif mode == "intbn":
                acc = conv.apply_id(blk["conv"], s_x)
                s_y = requant(apply_integer_bn(acc, blk["ibn"]), blk["rqt"])
            else:
                acc = conv.apply_id(blk["conv"], s_x)
                img = apply_thresholds(acc, blk["th"])  # [0, 2^bits - 1]
                s_y = (img + ACT_QMIN).to(torch.int8)
            s_x = pool.apply_id(s_y)
            if trace is not None:
                trace += [s_y, s_x]
        s_x = s_x.reshape(s_x.shape[0], -1)
        return self._head().apply_id(t["head"], s_x)


def tables_from_numpy(t_np: dict, device="cuda") -> dict:
    """A deployed CNN table tree (`NemoCNN.deploy`'s, or the reference's
    as plain numpy) -> the port's state on `device`: each conv through
    `QConv2d.load` (w_q in the GEMM's padded, transposed layout), each
    rqt as int32 tensors, `IntegerBNParams` through
    `integer_bn_to_torch`, the int64 thresholds cast to int32 as the
    reference casts them (`thresholds_to_torch`), the head's w_q stored
    transposed as `models.lm.tables_from_numpy` stores it; meta kept."""
    blocks = []
    for blk in t_np["blocks"]:
        w = np.asarray(blk["conv"]["w_q"])
        k, c_in, c_out = w.shape[0], w.shape[2], w.shape[3]
        out = {"conv": QConv2d(c_in, c_out, k).load(blk["conv"], device)}
        if "rqt" in blk:
            out["rqt"] = tree_to_torch(
                {n: np.asarray(v, np.int32) for n, v in blk["rqt"].items()},
                device)
        if "ibn" in blk:
            out["ibn"] = integer_bn_to_torch(blk["ibn"], device)
        if "th" in blk:
            out["th"] = thresholds_to_torch(blk["th"], device)
        blocks.append(out)
    return {"meta": dict(t_np["meta"]), "blocks": blocks,
            "head": tree_to_torch(t_np["head"], device)}


def image_inputs(img_u8: np.ndarray, device="cuda"):
    """uint8 NHWC images -> (float32 images img/255 for the float
    forwards, int8 images img - 128 at eps_in 1/255, zp -128, for the
    ID path), on `device`."""
    img = np.asarray(img_u8)
    x = torch.from_numpy((img / 255.0).astype(np.float32)).to(device)
    s_x = torch.from_numpy((img.astype(np.int16) - 128).astype(np.int8))
    return x, s_x.to(device)


def perturb_bn_np(p_np: dict, rng: np.random.Generator) -> dict:
    """Non-trivial BN statistics, drawn as the reference's pipeline test
    draws them (mu ~ 0.05 N, sigma ~ 1 + 0.3 U, gamma ~ 0.7 + 0.6 U,
    beta ~ 0.1 N, block by block), in place; a fresh BN is the identity
    and leaves the three BN strategies nothing to differ on."""
    for blk in p_np["blocks"]:
        bn = blk["bn"]
        bn["mu"] = rng.normal(size=bn["mu"].shape).astype(np.float32) * 0.05
        bn["sigma"] = (1.0 + 0.3 * rng.random(bn["sigma"].shape)).astype(
            np.float32)
        bn["gamma"] = (0.7 + 0.6 * rng.random(bn["gamma"].shape)).astype(
            np.float32)
        bn["beta"] = rng.normal(size=bn["beta"].shape).astype(
            np.float32) * 0.1
    return p_np
