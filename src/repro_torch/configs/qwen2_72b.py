"""Config module for --arch qwen2-72b (see registry.py for the entry)."""
from .registry import QWEN2_72B as CONFIG

CONFIG_ID = 'qwen2-72b'
