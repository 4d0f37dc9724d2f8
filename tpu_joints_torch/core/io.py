"""PCD / PLY file IO (a numpy copy of ``tpu_joints/core/io.py``).

Replaces ``pcl::io::loadPCDFile`` / ``savePCDFileASCII`` (reference
``SHOT.cpp:260``, ``crop_pcd.cpp:172``, ``segmentation.cpp:102``) and the VTK
PLY reader (``render.cpp:9-18``) with a dependency-free numpy implementation.
Supports PCD v0.7 ascii + binary, and PLY ascii + binary_little_endian with
vertices and (optionally) triangular faces.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

_PCD_DTYPES = {
    ("F", 4): np.float32,
    ("F", 8): np.float64,
    ("I", 1): np.int8,
    ("I", 2): np.int16,
    ("I", 4): np.int32,
    ("U", 1): np.uint8,
    ("U", 2): np.uint16,
    ("U", 4): np.uint32,
}


@dataclass
class PointData:
    """Host-side decoded cloud: xyz plus optional rgb/normals, compact."""

    xyz: np.ndarray
    rgb: Optional[np.ndarray] = None
    normals: Optional[np.ndarray] = None
    extra: Dict[str, np.ndarray] = field(default_factory=dict)

    def __len__(self) -> int:
        return int(self.xyz.shape[0])


def _unpack_pcl_rgb(raw: np.ndarray) -> np.ndarray:
    """PCL packs rgb(a) as a float32 whose bits are 0xAARRGGBB."""
    bits = raw.astype(np.float32).view(np.uint32)
    r = (bits >> 16) & 0xFF
    g = (bits >> 8) & 0xFF
    b = bits & 0xFF
    return np.stack([r, g, b], axis=1).astype(np.float32) / 255.0


def _pcd_header_fields(path: str) -> list:
    """Cheap sniff of the FIELDS line (first KB) for fast-path dispatch."""
    with open(path, "rb") as f:
        head = f.read(1024).decode("ascii", "replace")
    for line in head.splitlines():
        if line.upper().startswith("FIELDS"):
            return line.split()[1:]
    return []


def load_pcd(path: str) -> PointData:
    # fast path: the native C++ parser handles xyz(+rgb) files; fall back to
    # the Python decoder when the file carries normals/curvature or the
    # toolchain is unavailable
    fields = _pcd_header_fields(path)
    if fields and not any(f.startswith("normal") or f == "curvature" for f in fields):
        try:
            from tpu_joints_torch.native import load_pcd_native

            res = load_pcd_native(path)
        except Exception:
            res = None
        if res is not None:
            xyz, rgb = res
            finite_rgb = rgb if rgb is not None else None
            return PointData(xyz=xyz, rgb=finite_rgb)
    return _load_pcd_py(path)


def _load_pcd_py(path: str) -> PointData:
    with open(path, "rb") as f:
        header: Dict[str, List[str]] = {}
        while True:
            line = f.readline().decode("ascii", "replace").strip()
            if line.startswith("#") or not line:
                continue
            key, *vals = line.split()
            header[key.upper()] = vals
            if key.upper() == "DATA":
                break
        fields = header["FIELDS"]
        sizes = [int(s) for s in header["SIZE"]]
        types = header["TYPE"]
        counts = [int(c) for c in header.get("COUNT", ["1"] * len(fields))]
        npts = int(header["POINTS"][0])
        mode = header["DATA"][0].lower()

        names, formats = [], []
        for name, t, s, c in zip(fields, types, sizes, counts):
            dt = _PCD_DTYPES[(t, s)]
            for i in range(c):
                names.append(name if c == 1 else f"{name}_{i}")
                formats.append(dt)
        rec_dtype = np.dtype({"names": names, "formats": formats})

        if mode == "ascii":
            text = f.read().decode("ascii", "replace")
            rows = [r.split() for r in text.strip().splitlines() if r.strip()]
            arr = np.zeros(npts, dtype=rec_dtype)
            flat = np.array(rows[:npts], dtype=object)
            for j, name in enumerate(names):
                col = flat[:, j].astype(np.float64)
                arr[name] = col.astype(rec_dtype[name])
        elif mode == "binary":
            buf = f.read(rec_dtype.itemsize * npts)
            arr = np.frombuffer(buf, dtype=rec_dtype, count=npts)
        elif mode == "binary_compressed":
            import struct

            comp_size, uncomp_size = struct.unpack("<II", f.read(8))
            data = _lzf_decompress(f.read(comp_size), uncomp_size)
            # binary_compressed stores fields SoA-style
            arr = np.zeros(npts, dtype=rec_dtype)
            off = 0
            for name in names:
                dt = rec_dtype[name]
                nbytes = dt.itemsize * npts
                arr[name] = np.frombuffer(data[off : off + nbytes], dtype=dt)
                off += nbytes
        else:
            raise ValueError(f"unsupported PCD DATA mode: {mode}")

    xyz = np.stack([arr["x"], arr["y"], arr["z"]], axis=1).astype(np.float32)
    rgb = None
    for key in ("rgb", "rgba"):
        if key in names:
            rgb = _unpack_pcl_rgb(arr[key])
            break
    normals = None
    if all(k in names for k in ("normal_x", "normal_y", "normal_z")):
        normals = np.stack(
            [arr["normal_x"], arr["normal_y"], arr["normal_z"]], axis=1
        ).astype(np.float32)
    extra = {}
    if "curvature" in names:
        extra["curvature"] = np.asarray(arr["curvature"], np.float32)
    return PointData(xyz=xyz, rgb=rgb, normals=normals, extra=extra)


def _lzf_decompress(data: bytes, expected: int) -> bytes:
    """Minimal LZF decompressor (PCL uses liblzf for binary_compressed)."""
    out = bytearray()
    i = 0
    n = len(data)
    while i < n and len(out) < expected:
        ctrl = data[i]
        i += 1
        if ctrl < 32:  # literal run
            run = ctrl + 1
            out += data[i : i + run]
            i += run
        else:  # back reference
            length = ctrl >> 5
            if length == 7:
                length += data[i]
                i += 1
            ref = len(out) - ((ctrl & 0x1F) << 8) - data[i] - 1
            i += 1
            for _ in range(length + 2):
                out.append(out[ref])
                ref += 1
    return bytes(out)


def save_pcd(path: str, data: PointData, binary: bool = True) -> None:
    n = len(data)
    fields = ["x", "y", "z"]
    arrays = [data.xyz[:, 0], data.xyz[:, 1], data.xyz[:, 2]]
    if data.rgb is not None:
        rgb8 = np.clip(data.rgb * 255.0, 0, 255).astype(np.uint32)
        packed = (rgb8[:, 0] << 16) | (rgb8[:, 1] << 8) | rgb8[:, 2]
        fields.append("rgb")
        arrays.append(packed.view(np.float32))
    if data.normals is not None:
        fields += ["normal_x", "normal_y", "normal_z"]
        arrays += [data.normals[:, 0], data.normals[:, 1], data.normals[:, 2]]
    header = (
        "# .PCD v0.7 - Point Cloud Data file format\n"
        "VERSION 0.7\n"
        f"FIELDS {' '.join(fields)}\n"
        f"SIZE {' '.join(['4'] * len(fields))}\n"
        f"TYPE {' '.join(['F'] * len(fields))}\n"
        f"COUNT {' '.join(['1'] * len(fields))}\n"
        f"WIDTH {n}\nHEIGHT 1\nVIEWPOINT 0 0 0 1 0 0 0\nPOINTS {n}\n"
        f"DATA {'binary' if binary else 'ascii'}\n"
    )
    rec = np.zeros(n, dtype=np.dtype({"names": fields, "formats": [np.float32] * len(fields)}))
    for name, col in zip(fields, arrays):
        rec[name] = col.astype(np.float32) if name != "rgb" else col
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        if binary:
            f.write(rec.tobytes())
        else:
            np.savetxt(f, np.stack([rec[name] for name in fields], axis=1), fmt="%.8g")


_PLY_TYPES = {
    "char": np.int8, "int8": np.int8,
    "uchar": np.uint8, "uint8": np.uint8,
    "short": np.int16, "int16": np.int16,
    "ushort": np.uint16, "uint16": np.uint16,
    "int": np.int32, "int32": np.int32,
    "uint": np.uint32, "uint32": np.uint32,
    "float": np.float32, "float32": np.float32,
    "double": np.float64, "float64": np.float64,
}


def load_ply(path: str) -> Tuple[PointData, Optional[np.ndarray]]:
    """Load a PLY mesh → (vertex data, faces int32[M,3] or None)."""
    with open(path, "rb") as f:
        magic = f.readline().strip()
        if magic != b"ply":
            raise ValueError("not a PLY file")
        fmt = None
        elements: List[Tuple[str, int, List[Tuple[str, str, Optional[str]]]]] = []
        while True:
            line = f.readline().decode("ascii").strip()
            if line == "end_header":
                break
            toks = line.split()
            if not toks or toks[0] == "comment":
                continue
            if toks[0] == "format":
                fmt = toks[1]
            elif toks[0] == "element":
                elements.append((toks[1], int(toks[2]), []))
            elif toks[0] == "property":
                if toks[1] == "list":
                    elements[-1][2].append((toks[4], toks[3], toks[2]))
                else:
                    elements[-1][2].append((toks[2], toks[1], None))

        verts: Dict[str, np.ndarray] = {}
        faces = None
        for name, count, props in elements:
            if fmt == "ascii":
                rows = [f.readline().split() for _ in range(count)]
                if name == "vertex":
                    cols = np.array(rows, dtype=np.float64)
                    for j, (pname, _, _) in enumerate(props):
                        verts[pname] = cols[:, j]
                elif name == "face":
                    faces = np.array([[int(v) for v in r[1:4]] for r in rows], np.int32)
                # other elements: skip (already consumed)
            else:
                little = fmt == "binary_little_endian"
                order = "<" if little else ">"
                if all(p[2] is None for p in props):
                    dt = np.dtype(
                        {"names": [p[0] for p in props],
                         "formats": [np.dtype(_PLY_TYPES[p[1]]).newbyteorder(order) for p in props]}
                    )
                    arr = np.frombuffer(f.read(dt.itemsize * count), dtype=dt, count=count)
                    if name == "vertex":
                        for pname, _, _ in props:
                            verts[pname] = np.asarray(arr[pname], np.float64)
                else:
                    # list property (faces): parse row by row
                    rows = []
                    for _ in range(count):
                        pname, vtype, ctype = props[0]
                        cdt = np.dtype(_PLY_TYPES[ctype]).newbyteorder(order)
                        vdt = np.dtype(_PLY_TYPES[vtype]).newbyteorder(order)
                        k = int(np.frombuffer(f.read(cdt.itemsize), cdt)[0])
                        vals = np.frombuffer(f.read(vdt.itemsize * k), vdt, count=k)
                        rows.append(vals[:3])
                    if name == "face":
                        faces = np.array(rows, np.int32)

    xyz = np.stack([verts["x"], verts["y"], verts["z"]], axis=1).astype(np.float32)
    rgb = None
    if all(k in verts for k in ("red", "green", "blue")):
        rgb = np.stack([verts["red"], verts["green"], verts["blue"]], axis=1).astype(np.float32) / 255.0
    normals = None
    if all(k in verts for k in ("nx", "ny", "nz")):
        normals = np.stack([verts["nx"], verts["ny"], verts["nz"]], axis=1).astype(np.float32)
    return PointData(xyz=xyz, rgb=rgb, normals=normals), faces
