"""Fortran-namelist parser for MITgcm runtime config files.

Parses the reference's `data`, `eedata`, `data.pkg`, `data.<pkg>` files
directly so that reference experiment `input/` directories run unmodified
(reference syntax: eesupp/src/nml_set_terminator.F accepts both `&` and `/`
group terminators; values use Fortran literals like `1.E-4`, `.TRUE.`,
`62*20.E3` repeat counts, and `'quoted strings'`).

The port's own copy of mitgcm_tpu/core/nml.py; it reads, for example, the
KPP_PARM01 group of a `data.kpp` for model/kpp.py:KPP.
"""

from __future__ import annotations

import re
from typing import Any, Dict, List


_GROUP_RE = re.compile(r"^\s*&(\w+)\s*$")
_END_RE = re.compile(r"^\s*(&(end)?|/)\s*$", re.IGNORECASE)


def _strip_comment(line: str) -> str:
    # '#' starts a comment anywhere at line start in MITgcm inputs; be
    # conservative: only treat lines whose first non-blank char is '#' as
    # comments, plus strip trailing comments that start with ' #'.
    s = line.rstrip("\n")
    if s.lstrip().startswith("#"):
        return ""
    return s


def _tokenize_values(raw: str) -> List[str]:
    """Split a namelist value string into tokens, respecting quotes."""
    toks: List[str] = []
    buf = ""
    in_q: str | None = None
    for ch in raw:
        if in_q:
            buf += ch
            if ch == in_q:
                in_q = None
            continue
        if ch in "'\"":
            in_q = ch
            buf += ch
        elif ch in ", \t":
            if buf:
                toks.append(buf)
                buf = ""
        else:
            buf += ch
    if buf:
        toks.append(buf)
    return toks


_BOOL_TRUE = {".true.", "t", ".t."}
_BOOL_FALSE = {".false.", "f", ".f."}
_NUM_RE = re.compile(
    r"^[+-]?(\d+\.?\d*|\.\d+)([eEdD][+-]?\d+)?$"
)


def _convert_scalar(tok: str) -> Any:
    t = tok.strip()
    if not t:
        return None
    if t[0] in "'\"":
        return t[1:-1] if len(t) >= 2 and t[-1] == t[0] else t[1:]
    tl = t.lower()
    if tl in _BOOL_TRUE:
        return True
    if tl in _BOOL_FALSE:
        return False
    if _NUM_RE.match(t):
        # Fortran D exponents -> E
        tnum = t.replace("d", "e").replace("D", "E")
        if re.match(r"^[+-]?\d+$", tnum):
            return int(tnum)
        return float(tnum)
    return t  # bare string (e.g. file name without quotes)


def _convert_token(tok: str) -> List[Any]:
    """Convert one token, expanding Fortran repeat counts `n*value`."""
    m = re.match(r"^(\d+)\*(.*)$", tok)
    if m and not tok.strip().startswith(("'", '"')):
        n = int(m.group(1))
        val = _convert_scalar(m.group(2))
        return [val] * n
    return [_convert_scalar(tok)]


def parse_namelist(text: str) -> Dict[str, Dict[str, Any]]:
    """Parse namelist text into {GROUP: {var: value-or-list}}.

    Array-index assignments like `fields(1:2,1) = 'a','b'` keep their raw
    LHS as the key (callers that need indexed arrays, e.g. data.diagnostics,
    post-process them).
    """
    groups: Dict[str, Dict[str, Any]] = {}
    cur: Dict[str, Any] | None = None
    cur_key: str | None = None

    for rawline in text.splitlines():
        line = _strip_comment(rawline)
        if not line.strip():
            continue
        m = _GROUP_RE.match(line)
        if m and cur is None and not _END_RE.match(line):
            name = m.group(1).upper()
            if name != "END":
                cur = groups.setdefault(name, {})
                cur_key = None
                continue
        if cur is not None and _END_RE.match(line):
            cur = None
            cur_key = None
            continue
        if cur is None:
            continue
        # within a group: one or more `name = values` fragments, possibly a
        # continuation of the previous values list
        # split on the first '=' only; continuations have no '='
        if "=" in line:
            lhs, rhs = line.split("=", 1)
            key = lhs.strip()
            # leading commas on rhs are ok
            vals: List[Any] = []
            for tok in _tokenize_values(rhs):
                vals.extend(_convert_token(tok))
            vals = [v for v in vals if v is not None]
            cur[key.lower()] = vals
            cur_key = key.lower()
        else:
            if cur_key is None:
                continue
            vals = list(cur[cur_key])
            for tok in _tokenize_values(line):
                vals.extend(_convert_token(tok))
            cur[cur_key] = [v for v in vals if v is not None]

    # collapse singleton lists to scalars
    for g in groups.values():
        for k, v in list(g.items()):
            if isinstance(v, list) and len(v) == 1:
                g[k] = v[0]
    return groups


def read_namelist(path: str) -> Dict[str, Dict[str, Any]]:
    with open(path, "r", errors="replace") as f:
        return parse_namelist(f.read())
