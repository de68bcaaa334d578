"""Assigned architecture config: QWEN3_4B (see archs.py for the source)."""
from repro_torch.configs.archs import QWEN3_4B as CONFIG, smoke as _smoke

SMOKE = _smoke(CONFIG.name)
