"""The four NEMO representations (port of `repro.core.rep`; paper
§1-§3).

A model is always evaluated *in* a representation:

  FP  FullPrecision      : plain real-valued forward (paper §1).
  FQ  FakeQuantized      : Linear weights and Activation outputs are
                           real-valued but restricted to quantized grids
                           during forward-prop (paper §2).
  QD  QuantizedDeployable: every operator consumes/produces quantized
                           tensors; arithmetic still runs on real values
                           eps*q (paper §3, intro).
  ID  IntegerDeployable  : only integer images flow; requantization by
                           integer multiply + arithmetic right shift
                           (paper §3, Eq. 11/13).
"""
from __future__ import annotations

import enum


class Rep(enum.Enum):
    FP = "fp"
    FQ = "fq"
    QD = "qd"
    ID = "id"

    @property
    def is_integer(self) -> bool:
        return self is Rep.ID

    @property
    def is_quantized(self) -> bool:
        return self in (Rep.FQ, Rep.QD, Rep.ID)


# Canonical ordering of the deployment pipeline.
PIPELINE = (Rep.FP, Rep.FQ, Rep.QD, Rep.ID)
