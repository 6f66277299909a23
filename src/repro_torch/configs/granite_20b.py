"""Config module for --arch granite-20b (see registry.py for the entry)."""
from .registry import GRANITE_20B as CONFIG

CONFIG_ID = 'granite-20b'
