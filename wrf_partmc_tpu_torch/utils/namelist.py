"""Fortran namelist parser.

The port's own copy of ``wrf_partmc_tpu/utils/namelist.py``: reads
WRF-style ``namelist.input`` files into a dict of groups for
:func:`wrf_partmc_tpu_torch.config.namelist_to_config`.  Handles
'&group ... /' blocks, comments (!), Fortran logicals, numbers and strings,
and comma-separated lists (a list keeps its first entry, the single-domain
value, and the whole list under ``key + "__list"``).
"""

from __future__ import annotations

import re


def _parse_value(tok: str):
    t = tok.strip().rstrip(",").strip()
    if not t:
        return None
    low = t.lower()
    if low in (".true.", "t", ".t."):
        return True
    if low in (".false.", "f", ".f."):
        return False
    if (t.startswith("'") and t.endswith("'")) or (t.startswith('"') and t.endswith('"')):
        return t[1:-1]
    try:
        if re.fullmatch(r"[+-]?\d+", t):
            return int(t)
        return float(t.replace("d", "e").replace("D", "E"))
    except ValueError:
        return t


def parse_namelist(text: str) -> dict:
    """-> {group_name: {key: value}} (first value of any list)."""
    groups: dict = {}
    current = None
    for raw in text.splitlines():
        line = raw.split("!")[0].strip()
        if not line:
            continue
        if line.startswith("&"):
            current = line[1:].strip().lower()
            groups[current] = {}
            continue
        if line in ("/", "&end") or line.startswith("/"):
            current = None
            continue
        if current is None or "=" not in line:
            continue
        key, val = line.split("=", 1)
        key = key.strip().lower()
        vals = [v for v in (p.strip() for p in val.split(",")) if v != ""]
        parsed = [_parse_value(v) for v in vals]
        groups[current][key] = parsed[0] if parsed else None
        if len(parsed) > 1:
            groups[current][key + "__list"] = parsed
    return groups


def load_namelist(path: str) -> dict:
    with open(path) as f:
        return parse_namelist(f.read())
