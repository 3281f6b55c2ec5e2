"""Architecture registry: --arch <id> resolution.

Only the dense GQA architectures are registered: they run exactly the
modules the port has (attention, SwiGLU MLP, the two LM kernels). The
reference's other architectures need modules not ported yet (MoE, MLA,
Mamba, RWKV, encoder-decoder, vision), and asking for one raises.
"""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.granite_3_8b import CONFIG as GRANITE_3_8B
from repro_torch.configs.minicpm_2b import CONFIG as MINICPM_2B
from repro_torch.configs.phi3_medium_14b import CONFIG as PHI3_MEDIUM
from repro_torch.configs.yi_9b import CONFIG as YI_9B

ARCHS: "dict[str, ModelConfig]" = {
    c.name: c for c in (YI_9B, GRANITE_3_8B, PHI3_MEDIUM, MINICPM_2B)
}

#: Architectures of the reference that need modules the port lacks.
NOT_PORTED = (
    "rwkv6-1.6b", "llava-next-34b", "deepseek-v3-671b", "kimi-k2-1t-a32b",
    "jamba-1.5-large-398b", "seamless-m4t-large-v2",
)


def get_config(name: str) -> ModelConfig:
    """The config of arch `name` (underscores and unambiguous prefixes accepted)."""
    canon = name.replace("_", "-")
    for known in (ARCHS, NOT_PORTED):
        matches = [k for k in known if k == canon] or [k for k in known if k.startswith(canon)]
        if len(matches) == 1:
            if known is NOT_PORTED:
                raise NotImplementedError(
                    f"arch {matches[0]!r} is not ported yet; ported: {sorted(ARCHS)}"
                )
            return ARCHS[matches[0]]
    raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")

