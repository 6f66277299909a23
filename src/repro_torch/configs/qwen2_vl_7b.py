"""Config module for --arch qwen2-vl-7b (see registry.py for the entry)."""
from .registry import QWEN2_VL_7B as CONFIG

CONFIG_ID = 'qwen2-vl-7b'
