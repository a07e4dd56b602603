"""Architecture registry: ``--arch <id>`` resolution for every launcher."""

from __future__ import annotations

from repro_torch.configs.base import ALL_SHAPES, ModelConfig, ShapeConfig
from repro_torch.configs.command_r_35b import CONFIG as COMMAND_R_35B
from repro_torch.configs.deepseek_v2_lite import CONFIG as DEEPSEEK_V2_LITE
from repro_torch.configs.gemma3_4b import CONFIG as GEMMA3_4B
from repro_torch.configs.internvl2_2b import CONFIG as INTERNVL2_2B
from repro_torch.configs.llama4_maverick_400b_a17b import CONFIG as LLAMA4_MAVERICK
from repro_torch.configs.olmoe_1b_7b import CONFIG as OLMOE_1B_7B
from repro_torch.configs.phi3_medium_14b import CONFIG as PHI3_MEDIUM_14B
from repro_torch.configs.recurrentgemma_2b import CONFIG as RECURRENTGEMMA_2B
from repro_torch.configs.seamless_m4t_large_v2 import CONFIG as SEAMLESS_M4T
from repro_torch.configs.xlstm_350m import CONFIG as XLSTM_350M
from repro_torch.configs.yi_9b import CONFIG as YI_9B

ARCHS: dict[str, ModelConfig] = {
    c.name: c
    for c in (
        RECURRENTGEMMA_2B,
        PHI3_MEDIUM_14B,
        COMMAND_R_35B,
        YI_9B,
        GEMMA3_4B,
        LLAMA4_MAVERICK,
        OLMOE_1B_7B,
        XLSTM_350M,
        INTERNVL2_2B,
        SEAMLESS_M4T,
    )
}

# Architectures the port runs beyond the JAX package's assigned ten (they
# have no counterpart there, so the tests that hold ARCHS against the JAX
# package's registry leave them out).
PORT_ARCHS: dict[str, ModelConfig] = {c.name: c for c in (DEEPSEEK_V2_LITE,)}

SHAPES: dict[str, ShapeConfig] = {s.name: s for s in ALL_SHAPES}


def get_config(name: str) -> ModelConfig:
    if name.endswith("-smoke"):
        return get_config(name[: -len("-smoke")]).smoke()
    known = {**ARCHS, **PORT_ARCHS}
    if name not in known:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(known)}")
    return known[name]


def get_shape(name: str) -> ShapeConfig:
    if name not in SHAPES:
        raise KeyError(f"unknown shape {name!r}; known: {sorted(SHAPES)}")
    return SHAPES[name]


def all_cells() -> list[tuple[ModelConfig, ShapeConfig, bool]]:
    """Every (arch, shape, runnable) cell — 40 total, skips flagged False."""
    cells = []
    for cfg in ARCHS.values():
        run_names = {s.name for s in cfg.shapes()}
        for shape in ALL_SHAPES:
            cells.append((cfg, shape, shape.name in run_names))
    return cells
