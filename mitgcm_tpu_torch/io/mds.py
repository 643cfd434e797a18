"""MDS binary I/O: the reference's native field format.

Raw big-endian direct-access records (float32 or float64, no header), with a
companion text `.meta` descriptor (reference: pkg/mdsio/mdsio_write_meta.F,
reader mirror: utils/python/MITgcmutils/MITgcmutils/mds.py).

Only what the pickups need is implemented: multi-record files with an
`fldList` (model/src/write_pickup.F:107-279), global-file layout.

The port's own copy of the writer and the multi-record reader of
mitgcm_tpu/io/mds.py, for the pickups of model/experiment.py, which either
package reads.
"""

from __future__ import annotations

import os
import re
from typing import Dict, List, Optional, Tuple

import numpy as np


def write_raw(path: str, arr: np.ndarray, dtype: str = ">f4") -> None:
    np.asarray(arr, dtype=dtype).tofile(path)


_META_ITEM = re.compile(r"(\w+)\s*=\s*(\[[^\]]*\]|\{[^\}]*\}|[^;]*);", re.S)


def parse_meta(path: str) -> Dict[str, object]:
    """Parse a .meta descriptor (Matlab-ish syntax, mdsio_write_meta.F:104-160)."""
    with open(path) as f:
        txt = f.read()
    out: Dict[str, object] = {}
    for m in _META_ITEM.finditer(txt):
        key, val = m.group(1), m.group(2).strip()
        if val.startswith("["):
            body = val[1:-1]
            rows = [r.strip() for r in body.split(";") if r.strip()]
            parsed_rows: List[List[object]] = []
            for r in rows:
                items = []
                for tok in r.replace(",", " ").split():
                    tok = tok.strip("'\"")
                    try:
                        items.append(int(tok))
                    except ValueError:
                        try:
                            items.append(float(tok))
                        except ValueError:
                            items.append(tok)
                parsed_rows.append(items)
            if len(parsed_rows) == 1:
                row = parsed_rows[0]
                out[key] = row[0] if len(row) == 1 else row
            else:
                out[key] = parsed_rows
        elif val.startswith("{"):
            out[key] = [t.strip().strip("'\"") for t in val[1:-1].split()]
        else:
            v = val.strip().strip("'\"")
            try:
                out[key] = int(v)
            except ValueError:
                out[key] = v
    return out


def wrmds(
    froot: str,
    arr: np.ndarray,
    itr: Optional[int] = None,
    dataprec: str = "float64",
    nrecords: Optional[int] = None,
    fldlist: Optional[List[str]] = None,
    timestep_number: Optional[int] = None,
) -> None:
    """Write an MDS field + .meta (global-file layout).

    arr: [nrec?, (nz?), ny, nx]; dimList is written x-first per the
    reference convention (mdsio_write_meta.F).
    """
    if itr is not None:
        froot = f"{froot}.{itr:010d}"
    dtype = ">f4" if dataprec == "float32" else ">f8"
    a = np.asarray(arr)
    if nrecords is not None and nrecords > 1:
        dims = a.shape[1:]
    else:
        nrecords = 1
        dims = a.shape
    gdims = list(dims)[::-1]  # x first
    write_raw(froot + ".data", a, dtype)
    lines = [f" nDims = [ {len(gdims):3d} ];", " dimList = ["]
    rows = [f" {n:5d},{1:5d},{n:5d}" for n in gdims]
    # reference row separator: comma-terminated rows, no trailing comma on the
    # last row (mdsio_write_meta.F:120 writes 3(I5,",")); MITgcmutils.mds
    # parsemeta rejects ';'-separated rows
    lines.append(",\n".join(rows))
    lines.append(" ];")
    lines.append(f" dataprec = [ '{dataprec}' ];")
    lines.append(f" nrecords = [ {nrecords:5d} ];")
    if timestep_number is not None:
        lines.append(f" timeStepNumber = [ {timestep_number:10d} ];")
    if fldlist is not None:
        body = " ".join(f"'{f:<8s}'" for f in fldlist)
        lines.append(f" nFlds = [ {len(fldlist):4d} ];")
        lines.append(" fldList = {")
        lines.append(body)
        lines.append(" };")
    with open(froot + ".meta", "w") as f:
        f.write("\n".join(lines) + "\n")


def read_mflds(froot: str, itr: Optional[int] = None) -> Tuple[Dict[str, np.ndarray], Dict]:
    """Read a multi-field MDS file (pickup); returns {fldName: array}, meta.

    Mirrors pkg/rw/read_mflds.F: records are stacked along the leading axis;
    3-D fields occupy Nr records each, 2-D fields one record, in fldList
    order. The caller splits by known field dimensionality; here we return
    the raw record stack plus fldList so model code can slice.
    """
    if itr is not None:
        froot_i = f"{froot}.{itr:010d}"
    else:
        froot_i = froot
    meta = parse_meta(froot_i + ".meta")
    dimrows = meta["dimList"]
    if dimrows and not isinstance(dimrows[0], list):
        dimrows = [dimrows]
    # old-style metas put all dims on newline-separated rows that parse
    # as one flat list [nx,1,nx, ny,1,ny]: chunk into rows of 3
    if len(dimrows) == 1 and len(dimrows[0]) > 3:
        flat = dimrows[0]
        dimrows = [flat[i:i + 3] for i in range(0, len(flat), 3)]
    gdims = [int(r[0]) for r in dimrows]
    prec = meta.get("dataprec", "float64")
    if isinstance(prec, list):
        prec = prec[0]
    dtype = ">f4" if "32" in str(prec) else ">f8"
    nx, ny = gdims[0], gdims[1]
    # old-style pickups have no ".data" suffix (e.g. pickup.0000036000)
    dpath = froot_i + ".data"
    if not os.path.exists(dpath):
        dpath = froot_i
    data = np.fromfile(dpath, dtype=dtype)
    nslab = data.size // (nx * ny)
    stack = data.reshape(nslab, ny, nx)
    return {"__records__": stack}, meta

