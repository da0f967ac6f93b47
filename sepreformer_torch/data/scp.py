"""Kaldi-style scp manifest parsing (ref: utils/util_dataset.py:8-25)."""

from __future__ import annotations

from typing import Dict


def parse_scps(path: str) -> Dict[str, str]:
    """Parse ``<key> <abs-path>`` lines; duplicate keys are an error."""
    table: Dict[str, str] = {}
    with open(path) as f:
        for ln, line in enumerate(f, 1):
            parts = line.strip().split()
            if not parts:
                continue
            if len(parts) != 2:
                raise ValueError(f"{path}:{ln}: expected '<key> <path>', got {line!r}")
            key, value = parts
            if key in table:
                raise ValueError(f"{path}:{ln}: duplicate key {key!r}")
            table[key] = value
    return table
