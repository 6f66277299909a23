"""Config module for --arch llama4-scout-17b-a16e (see registry.py for the entry)."""
from .registry import LLAMA4_SCOUT as CONFIG

CONFIG_ID = 'llama4-scout-17b-a16e'
