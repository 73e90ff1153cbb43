"""Minimal PLY reader/writer in pure numpy.

Copy of ``triangle_splatting_tpu/utils/ply.py`` without its native fast
path (the port carries no copy of ``native.py``).

Supports ascii and binary_little_endian, scalar properties, and uint8-count
int32-index list properties (faces). Schema-compatible with the files the
reference reads/writes via ``plyfile`` (raw_triangle.py / raw_gaussian.py /
point_cloud.py).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

_TYPES = {
    "char": "i1", "int8": "i1", "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2", "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4", "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4", "double": "f8", "float64": "f8",
}
_INV_TYPES = {"u1": "uchar", "i1": "char", "u2": "ushort", "i2": "short",
              "i4": "int", "u4": "uint", "f4": "float", "f8": "double"}


def read_ply(path) -> dict[str, np.ndarray]:
    """Read a PLY file -> {element_name: structured array}.

    List properties become object-dtype columns only if variable-length;
    fixed-length triangle faces come back as an (N, 3) int column named by
    the property.
    """
    with open(path, "rb") as f:
        line = f.readline().strip()
        if line != b"ply":
            raise ValueError("not a PLY file")
        fmt = None
        elements = []     # (name, count, [(prop_name, dtype or ('list', ct, it))])
        while True:
            line = f.readline().strip().decode("ascii")
            if line == "end_header":
                break
            parts = line.split()
            if not parts or parts[0] == "comment":
                continue
            if parts[0] == "format":
                fmt = parts[1]
            elif parts[0] == "element":
                elements.append((parts[1], int(parts[2]), []))
            elif parts[0] == "property":
                if parts[1] == "list":
                    elements[-1][2].append(
                        (parts[4], ("list", _TYPES[parts[2]], _TYPES[parts[3]])))
                else:
                    elements[-1][2].append((parts[2], _TYPES[parts[1]]))

        out = {}
        if fmt == "ascii":
            tokens = f.read().split()
            pos = 0
            for name, count, props in elements:
                has_list = any(isinstance(t, tuple) for _, t in props)
                if not has_list:
                    dt = np.dtype([(p, t) for p, t in props])
                    width = len(props)
                    arr = np.array(tokens[pos:pos + count * width],
                                   dtype="f8").reshape(count, width)
                    pos += count * width
                    rec = np.zeros(count, dt)
                    for i, (p, t) in enumerate(props):
                        rec[p] = arr[:, i].astype(t)
                    out[name] = rec
                else:
                    rows = []
                    for _ in range(count):
                        n = int(tokens[pos]); pos += 1
                        rows.append([int(x) for x in tokens[pos:pos + n]])
                        pos += n
                    out[name] = np.array(rows)
            return out

        if fmt != "binary_little_endian":
            raise ValueError(f"unsupported PLY format {fmt}")
        for name, count, props in elements:
            has_list = any(isinstance(t, tuple) for _, t in props)
            if not has_list:
                dt = np.dtype([(p, "<" + t) for p, t in props])
                out[name] = np.frombuffer(f.read(dt.itemsize * count), dtype=dt).copy()
            else:
                # Assume one list property per element with a constant count
                # (triangle faces) — the only list layout we emit or consume.
                (pname, (_, ct, it)) = props[0]
                ct_size = np.dtype(ct).itemsize
                it_size = np.dtype(it).itemsize
                head = f.read(ct_size)
                if count == 0:
                    out[name] = np.zeros((0, 3), np.int32)
                    continue
                first = int(np.frombuffer(head, dtype=ct)[0])
                row_bytes = ct_size + first * it_size
                rest = f.read(count * row_bytes - ct_size)
                buf = np.frombuffer(head + rest, np.uint8).reshape(count, row_bytes)
                idx = np.ascontiguousarray(buf[:, ct_size:]).view("<" + it)
                out[name] = idx.reshape(count, first)
        return out


def write_ply(path, elements: dict[str, np.ndarray],
              faces: np.ndarray | None = None,
              face_element: str = "face") -> None:
    """Write structured arrays as binary_little_endian PLY.

    ``elements`` maps element name -> structured numpy array. ``faces`` is an
    optional (N, 3) int32 array written as a vertex_indices list property.
    """
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    header = ["ply", "format binary_little_endian 1.0"]
    for name, rec in elements.items():
        header.append(f"element {name} {len(rec)}")
        for p in rec.dtype.names:
            t = _INV_TYPES[rec.dtype[p].str.lstrip("<>|=")]
            header.append(f"property {t} {p}")
    if faces is not None:
        header.append(f"element {face_element} {len(faces)}")
        header.append("property list uchar int vertex_indices")
    header.append("end_header")

    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode("ascii"))
        for rec in elements.values():
            # force little-endian
            le = rec.astype(np.dtype([(p, "<" + rec.dtype[p].str.lstrip("<>|="))
                                      for p in rec.dtype.names]))
            f.write(le.tobytes())
        if faces is not None:
            n = len(faces)
            rows = np.zeros(n, dtype=[("c", "u1"), ("i", "<i4", (3,))])
            rows["c"] = 3
            rows["i"] = faces.astype(np.int32)
            f.write(rows.tobytes())
