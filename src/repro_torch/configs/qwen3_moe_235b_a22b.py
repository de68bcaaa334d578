"""Assigned architecture config: QWEN3_MOE_235B (see archs.py for the source)."""
from repro_torch.configs.archs import QWEN3_MOE_235B as CONFIG, smoke as _smoke

SMOKE = _smoke(CONFIG.name)
