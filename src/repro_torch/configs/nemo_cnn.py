"""The paper's own model class: an MCU-scale Conv-BN-ReLU CNN
exercising the complete NEMO pipeline (FP -> FQ -> QD -> ID) including
BN folding, integer BN, threshold activations and integer average
pooling.  Its model is `repro_torch.models.cnn.NemoCNN`, not
`DecoderLM`; the serving CLI offers only the LM configs."""
from repro_torch.configs.base import ArchConfig, register

register(ArchConfig(
    name="nemo_cnn", family="cnn", n_layers=4, d_model=32, vocab=10,
    act="relu", gated=False, norm="layer",
    notes="paper-faithful CNN demo; see models/cnn.py",
))
