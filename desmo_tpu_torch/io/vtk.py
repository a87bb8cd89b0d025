"""Pure-Python VTK snapshot readers (no ``vtk`` package required).

The reference's L1 layer wraps the VTK C++ library through its Python bindings
(``DESMO/cylinder_flow/DESMO-Cylinder.py:39-85``): ``.vtu`` XML unstructured
grids for cylinder/aneurysm (PointData/CellData array "velocity") and legacy
``.vtk`` rectilinear grids for the JHTDB channel (PointData "Velocity",
``DESMO/turbulent_channel/DESMO-TurbulentChannel.py:55-59``). This module
implements both formats directly:

* **XML .vtu/.vti/.vtr** — ascii, inline-base64, and appended (raw or base64)
  data arrays, with optional vtkZLibDataCompressor block compression.
* **Legacy .vtk** — ASCII and binary (big-endian per the VTK spec);
  STRUCTURED_POINTS / RECTILINEAR_GRID / UNSTRUCTURED_GRID datasets with
  SCALARS / VECTORS / FIELD attributes in POINT_DATA / CELL_DATA.

``read_snapshot_series`` reproduces ``read_velocity_data``'s exact snapshot
matrix layout: each snapshot's (npoints, ncomp) array is C-flattened into one
column, so rows are (u, v, w) interleaved per point (``CYL:69-80``).

An optional native (C++) fast path for the hot inner decode loop lives in
``desmo_tpu_torch.io.native``; this module is the always-available reference
implementation.

The port's own copy of the readers of ``desmo_tpu/io/vtk.py`` (the writers
and the column-block streamer are not ported); ``tests/test_torch_io.py``
holds the two equal on generated files.
"""

from __future__ import annotations

import base64
import dataclasses
import zlib
from typing import Optional
from xml.etree import ElementTree

import numpy as np

__all__ = [
    "Mesh",
    "read_vtu",
    "read_legacy_vtk",
    "read_mesh",
    "read_snapshot_series",
]

_XML_DTYPES = {
    "Float32": np.dtype("<f4"),
    "Float64": np.dtype("<f8"),
    "Int8": np.dtype("<i1"),
    "Int16": np.dtype("<i2"),
    "Int32": np.dtype("<i4"),
    "Int64": np.dtype("<i8"),
    "UInt8": np.dtype("<u1"),
    "UInt16": np.dtype("<u2"),
    "UInt32": np.dtype("<u4"),
    "UInt64": np.dtype("<u8"),
}

_LEGACY_DTYPES = {
    "float": np.dtype(">f4"),
    "double": np.dtype(">f8"),
    "int": np.dtype(">i4"),
    "long": np.dtype(">i8"),
    "short": np.dtype(">i2"),
    "char": np.dtype(">i1"),
    "unsigned_char": np.dtype(">u1"),
    "unsigned_int": np.dtype(">u4"),
    "unsigned_long": np.dtype(">u8"),
    "unsigned_short": np.dtype(">u2"),
}


@dataclasses.dataclass
class Mesh:
    """Geometry + attribute arrays of one snapshot file.

    ``points`` is (npoints, 3); for image/rectilinear data it is synthesized
    from the axis coordinates. ``cells``/``cell_types`` follow VTK's
    connectivity+offsets convention when present.
    """

    points: Optional[np.ndarray]
    point_data: dict[str, np.ndarray]
    cell_data: dict[str, np.ndarray]
    cells: Optional[np.ndarray] = None  # connectivity
    cell_offsets: Optional[np.ndarray] = None
    cell_types: Optional[np.ndarray] = None
    dimensions: Optional[tuple[int, int, int]] = None  # structured datasets
    axis_coordinates: Optional[tuple[np.ndarray, np.ndarray, np.ndarray]] = None

    def array(self, name: str, location: str = "point") -> np.ndarray:
        data = self.point_data if location == "point" else self.cell_data
        try:
            return data[name]
        except KeyError:
            raise KeyError(
                f"no {location}-data array {name!r}; available: {sorted(data)}"
            ) from None


# ---------------------------------------------------------------------------
# XML (.vtu / .vtr / .vti) reading
# ---------------------------------------------------------------------------


def _byte_order(root) -> str:
    return "<" if root.get("byte_order", "LittleEndian") == "LittleEndian" else ">"


def _decode_block(raw: bytes, header_dtype, dtype, compressed: bool) -> bytes:
    """Decode one [header][payload] region (inline-binary or raw-appended)."""
    hsize = header_dtype.itemsize
    if not compressed:
        (nbytes,) = np.frombuffer(raw[:hsize], header_dtype)
        return raw[hsize : hsize + int(nbytes)]
    # vtkZLibDataCompressor: [nblocks, blocksize, last_blocksize, sizes...]
    nblocks = int(np.frombuffer(raw[:hsize], header_dtype)[0])
    header = np.frombuffer(raw[: (3 + nblocks) * hsize], header_dtype)
    sizes = header[3 : 3 + nblocks].astype(np.int64)
    out = bytearray()
    pos = (3 + nblocks) * hsize
    for s in sizes:
        out += zlib.decompress(raw[pos : pos + int(s)])
        pos += int(s)
    return bytes(out)


def _decode_base64_compressed(text: str, header_dtype, compressed: bool) -> bytes:
    """Inline/appended base64: the header is base64-encoded SEPARATELY from
    the payload, so the payload stream starts on its own 4-char boundary."""
    hsize = header_dtype.itemsize
    if not compressed:
        first = base64.b64decode(text[: 4 * ((hsize + 2) // 3) + 4])
        (nbytes,) = np.frombuffer(first[:hsize], header_dtype)
        head_chars = 4 * ((hsize + 2) // 3)
        payload = base64.b64decode(text[head_chars:].encode() + b"==")
        return payload[: int(nbytes)]
    # need nblocks first to know the full header length
    first = base64.b64decode(text[: 4 * ((hsize + 2) // 3) + 4])
    nblocks = int(np.frombuffer(first[:hsize], header_dtype)[0])
    header_bytes = (3 + nblocks) * hsize
    head_chars = 4 * ((header_bytes + 2) // 3)
    header = np.frombuffer(
        base64.b64decode(text[:head_chars])[:header_bytes], header_dtype
    )
    sizes = header[3 : 3 + nblocks].astype(np.int64)
    payload = base64.b64decode(text[head_chars:].encode() + b"==")
    out = bytearray()
    pos = 0
    for s in sizes:
        out += zlib.decompress(payload[pos : pos + int(s)])
        pos += int(s)
    return bytes(out)


class _XmlArrayReader:
    def __init__(self, root: ElementTree.Element, blob: bytes):
        self.order = _byte_order(root)
        self.header_dtype = _XML_DTYPES[root.get("header_type", "UInt32")].newbyteorder(
            self.order
        )
        self.compressed = root.get("compressor") is not None
        self.appended_raw: Optional[bytes] = None
        self.appended_b64: Optional[str] = None
        app = root.find("AppendedData")
        if app is not None:
            if app.get("encoding", "base64") == "raw":
                idx = blob.find(b"<AppendedData")
                start = blob.index(b"_", idx) + 1
                end = blob.rindex(b"</AppendedData>")
                self.appended_raw = blob[start:end]
            else:
                text = app.text or ""
                self.appended_b64 = text.strip().lstrip("_")

    def read(self, el: ElementTree.Element) -> np.ndarray:
        dtype = _XML_DTYPES[el.get("type")].newbyteorder(self.order)
        ncomp = int(el.get("NumberOfComponents", "1"))
        fmt = el.get("format", "ascii")
        if fmt == "ascii":
            flat = np.array((el.text or "").split(), dtype=dtype.newbyteorder("="))
        elif fmt == "binary":
            data = _decode_base64_compressed(
                (el.text or "").strip(), self.header_dtype, self.compressed
            )
            flat = np.frombuffer(data, dtype)
        elif fmt == "appended":
            offset = int(el.get("offset", "0"))
            if self.appended_raw is not None:
                data = _decode_block(
                    self.appended_raw[offset:], self.header_dtype, dtype, self.compressed
                )
            elif self.appended_b64 is not None:
                data = _decode_base64_compressed(
                    self.appended_b64[offset:], self.header_dtype, self.compressed
                )
            else:
                raise ValueError("appended DataArray but no AppendedData section")
            flat = np.frombuffer(data, dtype)
        else:
            raise ValueError(f"unsupported DataArray format {fmt!r}")
        flat = flat.astype(dtype.newbyteorder("="), copy=False)
        return flat.reshape(-1, ncomp) if ncomp > 1 else flat


def read_vtu(path: str) -> Mesh:
    """Read an XML VTK file (.vtu unstructured; also handles .vtr/.vti pieces)."""
    with open(path, "rb") as f:
        blob = f.read()
    # appended raw data is not valid XML; parse only up to the AppendedData payload
    root = ElementTree.fromstring(_xml_safe(blob))
    reader = _XmlArrayReader(root, blob)
    grid = next(
        (root.find(t) for t in ("UnstructuredGrid", "RectilinearGrid", "ImageData") if root.find(t) is not None),
        None,
    )
    if grid is None:
        raise ValueError(f"{path}: no supported grid element")
    piece = grid.find("Piece")

    def read_section(tag: str) -> dict[str, np.ndarray]:
        out = {}
        section = piece.find(tag)
        if section is not None:
            for el in section.findall("DataArray"):
                out[el.get("Name")] = reader.read(el)
        return out

    points = None
    pts_el = piece.find("Points")
    if pts_el is not None:
        points = reader.read(pts_el.find("DataArray"))
    cells = offsets = types = None
    cells_el = piece.find("Cells")
    if cells_el is not None:
        arrays = {el.get("Name"): reader.read(el) for el in cells_el.findall("DataArray")}
        cells = arrays.get("connectivity")
        offsets = arrays.get("offsets")
        types = arrays.get("types")
    return Mesh(
        points=points,
        point_data=read_section("PointData"),
        cell_data=read_section("CellData"),
        cells=cells,
        cell_offsets=offsets,
        cell_types=types,
    )


def _xml_safe(blob: bytes) -> bytes:
    """Strip a raw-encoded AppendedData payload so the rest parses as XML."""
    idx = blob.find(b'<AppendedData encoding="raw"')
    if idx == -1:
        return blob
    start = blob.index(b">", idx) + 1
    end = blob.rindex(b"</AppendedData>")
    return blob[:start] + b" " + blob[end:]


# ---------------------------------------------------------------------------
# Legacy .vtk reading
# ---------------------------------------------------------------------------


class _LegacyScanner:
    def __init__(self, blob: bytes, binary: bool):
        self.blob = blob
        self.pos = 0
        self.binary = binary

    def line(self) -> str:
        end = self.blob.find(b"\n", self.pos)
        if end == -1:
            end = len(self.blob)
        line = self.blob[self.pos : end].decode("ascii", "replace").strip()
        self.pos = min(end + 1, len(self.blob))
        return line

    def peek_line(self) -> str:
        save = self.pos
        try:
            line = self.line()
        except ValueError:
            return ""
        self.pos = save
        return line

    def at_end(self) -> bool:
        while self.pos < len(self.blob) and self.blob[self.pos : self.pos + 1] in b"\r\n \t":
            self.pos += 1
        return self.pos >= len(self.blob)

    def values(self, count: int, vtk_type: str) -> np.ndarray:
        dtype = _LEGACY_DTYPES[vtk_type]
        if self.binary:
            nbytes = count * dtype.itemsize
            arr = np.frombuffer(self.blob[self.pos : self.pos + nbytes], dtype)
            self.pos += nbytes
            return arr.astype(dtype.newbyteorder("="), copy=False)
        vals: list[str] = []
        while len(vals) < count:
            vals.extend(self.line().split())
        return np.array(vals[:count], dtype=dtype.newbyteorder("="))


def read_legacy_vtk(path: str) -> Mesh:
    """Read a legacy-format VTK file (ASCII or big-endian binary)."""
    with open(path, "rb") as f:
        blob = f.read()
    sc = _LegacyScanner(blob, binary=False)
    if not sc.line().startswith("# vtk DataFile"):
        raise ValueError(f"{path}: not a legacy VTK file")
    sc.line()  # title
    mode = sc.line().upper()
    sc.binary = mode == "BINARY"
    dataset_line = sc.line().split()
    if dataset_line[0].upper() != "DATASET":
        raise ValueError(f"{path}: expected DATASET, got {dataset_line}")
    kind = dataset_line[1].upper()

    mesh = Mesh(points=None, point_data={}, cell_data={})
    npoints = ncells = 0

    if kind in ("STRUCTURED_POINTS", "RECTILINEAR_GRID", "STRUCTURED_GRID"):
        dims = None
        coords: dict[str, np.ndarray] = {}
        origin = np.zeros(3)
        spacing = np.ones(3)
        while True:
            line_start = sc.pos
            line = sc.line()
            tok = line.split()
            key = tok[0].upper()
            if key == "DIMENSIONS":
                dims = tuple(int(v) for v in tok[1:4])
            elif key in ("X_COORDINATES", "Y_COORDINATES", "Z_COORDINATES"):
                coords[key[0]] = sc.values(int(tok[1]), tok[2])
            elif key == "ORIGIN":
                origin = np.array([float(v) for v in tok[1:4]])
            elif key == "SPACING" or key == "ASPECT_RATIO":
                spacing = np.array([float(v) for v in tok[1:4]])
            elif key == "POINTS":
                mesh.points = sc.values(int(tok[1]) * 3, tok[2]).reshape(-1, 3)
            elif key in ("POINT_DATA", "CELL_DATA"):
                sc.pos = line_start
                break
            if sc.at_end():
                break
        if dims is None:
            raise ValueError(f"{path}: structured dataset without DIMENSIONS")
        mesh.dimensions = dims
        if kind == "RECTILINEAR_GRID":
            ax = tuple(coords.get(a, np.zeros(d)) for a, d in zip("XYZ", dims))
            mesh.axis_coordinates = ax
        elif kind == "STRUCTURED_POINTS":
            mesh.axis_coordinates = tuple(
                origin[i] + spacing[i] * np.arange(dims[i]) for i in range(3)
            )
        if mesh.points is None and mesh.axis_coordinates is not None:
            gz, gy, gx = np.meshgrid(*mesh.axis_coordinates[::-1], indexing="ij")
            mesh.points = np.stack([gx, gy, gz], axis=-1).reshape(-1, 3)
        npoints = int(np.prod(dims))
        ncells = int(np.prod([max(d - 1, 1) for d in dims]))
    elif kind == "UNSTRUCTURED_GRID":
        while True:
            line_start = sc.pos
            line = sc.line()
            tok = line.split()
            key = tok[0].upper()
            if key == "POINTS":
                npoints = int(tok[1])
                mesh.points = sc.values(npoints * 3, tok[2]).reshape(-1, 3)
            elif key == "CELLS":
                ncells = int(tok[1])
                raw = sc.values(int(tok[2]), "int")
                mesh.cells = raw
            elif key == "CELL_TYPES":
                mesh.cell_types = sc.values(int(tok[1]), "int")
            elif key in ("POINT_DATA", "CELL_DATA"):
                sc.pos = line_start
                break
            if sc.at_end():
                break
    else:
        raise ValueError(f"{path}: unsupported legacy dataset {kind}")

    # attribute sections
    target, count = None, 0
    while not sc.at_end():
        line = sc.line()
        if not line:
            continue
        tok = line.split()
        key = tok[0].upper()
        if key == "POINT_DATA":
            target, count = mesh.point_data, int(tok[1])
        elif key == "CELL_DATA":
            target, count = mesh.cell_data, int(tok[1])
        elif key == "SCALARS":
            name, vtk_type = tok[1], tok[2]
            ncomp = int(tok[3]) if len(tok) > 3 else 1
            if sc.peek_line().upper().startswith("LOOKUP_TABLE"):
                sc.line()
            data = sc.values(count * ncomp, vtk_type)
            target[name] = data.reshape(-1, ncomp) if ncomp > 1 else data
        elif key == "VECTORS":
            name, vtk_type = tok[1], tok[2]
            target[name] = sc.values(count * 3, vtk_type).reshape(-1, 3)
        elif key == "FIELD":
            n_arrays = int(tok[2])
            for _ in range(n_arrays):
                atok = sc.line().split()
                aname, ncomp, tuples, vtk_type = (
                    atok[0],
                    int(atok[1]),
                    int(atok[2]),
                    atok[3],
                )
                data = sc.values(ncomp * tuples, vtk_type)
                target[aname] = data.reshape(-1, ncomp) if ncomp > 1 else data
    return mesh


# ---------------------------------------------------------------------------
# Snapshot-series assembly (the reference's read_velocity_data)
# ---------------------------------------------------------------------------


def read_mesh(path: str) -> Mesh:
    if path.endswith((".vtu", ".vtr", ".vti", ".pvtu", ".xml")):
        return read_vtu(path)
    return read_legacy_vtk(path)


def read_snapshot_series(
    input_dir: str,
    filename: str,
    t_start: int,
    t_end: int,
    extension: str = ".vtu",
    array: str = "velocity",
    location: str = "point",
) -> tuple[np.ndarray, Mesh]:
    """Assemble the snapshot matrix exactly like ``read_velocity_data``
    (``CYL:39-85``): X[:, j] is snapshot ``t_start + j``'s attribute array
    C-flattened (components interleaved per point). Returns (X, last mesh)."""
    columns = []
    mesh: Optional[Mesh] = None
    sep = "" if input_dir.endswith("/") or not input_dir else "/"
    for i in range(t_start, t_end):
        mesh = read_mesh(f"{input_dir}{sep}{filename}{i}{extension}")
        columns.append(np.asarray(mesh.array(array, location)).reshape(-1))
    if not columns:
        raise ValueError("empty snapshot range")
    x = np.stack(columns, axis=1)
    return x, mesh
