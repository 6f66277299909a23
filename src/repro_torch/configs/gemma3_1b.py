"""Config module for --arch gemma3-1b (see registry.py for the entry)."""
from .registry import GEMMA3_1B as CONFIG

CONFIG_ID = 'gemma3-1b'
