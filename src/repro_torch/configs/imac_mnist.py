"""The paper's own workload: 400x120x84x10 sigmoid MLP deployed on IMAC
(Tables II-IV)."""
from repro_torch.core.imac import IMACConfig

TOPOLOGY = [400, 120, 84, 10]

# Table II fixed hyperparameters.
PAPER_DEFAULTS = dict(
    vdd=0.8,
    vss=-0.8,
    neuron="sigmoid",
    t_sampling=20e-9,
)

# Table III array-size sweep (auto H_P/V_P) + the over-partitioned row.
TABLE_III_CONFIGS = [
    ("32x32", IMACConfig(tech="MRAM", array_rows=32, array_cols=32, **PAPER_DEFAULTS)),
    ("64x64", IMACConfig(tech="MRAM", array_rows=64, array_cols=64, **PAPER_DEFAULTS)),
    ("128x128", IMACConfig(tech="MRAM", array_rows=128, array_cols=128, **PAPER_DEFAULTS)),
    ("256x256", IMACConfig(tech="MRAM", array_rows=256, array_cols=256, **PAPER_DEFAULTS)),
    ("512x512", IMACConfig(tech="MRAM", array_rows=512, array_cols=512, **PAPER_DEFAULTS)),
    ("32x32-hp16", IMACConfig(tech="MRAM", hp=[16, 8, 8], vp=[8, 8, 1], **PAPER_DEFAULTS)),
]

# Table IV device-technology sweep at fixed H_P=[13,4,3], V_P=[4,3,1].
TABLE_IV_CONFIGS = [
    (tech, IMACConfig(tech=tech, hp=[13, 4, 3], vp=[4, 3, 1], **PAPER_DEFAULTS))
    for tech in ("MRAM", "RRAM", "CBRAM", "PCM")
]
