"""Binary wire codec for the serving data plane: length-prefixed frames
(counterpart: ``trpo_tpu/serve/wire.py``, copied: numpy only, and frames
byte-identical to the reference's, so each package decodes the other's).

A small policy's inference can cost less than one request's Python/HTTP
overhead, and a visible slice of that overhead is the payload format
itself: a JSON act body round-trips every float
through ``repr``/``float()`` and builds a Python list per array. This
module replaces the float lists with a **versioned, length-prefixed
binary frame** — a small JSON metadata header (scalars + per-array
dtype/shape manifest) followed by each array's raw little-endian bytes
— decoded as ZERO-COPY numpy views over the request body. JSON stays
the default external format and the compatibility fallback: the codec
is negotiated per-connection via plain content negotiation
(``Content-Type`` on the request, ``Accept`` for the response), so a
curl user and an old client keep working unchanged.

Frame layout (all integers little-endian)::

    offset  size  field
    0       2     magic  b"TW"
    2       1     version (currently 1)
    3       1     reserved (0)
    4       4     u32 meta length M
    8       M     meta: UTF-8 JSON
                  {"f": {scalar fields}, "a": [[name, dtype, shape], …]}
    8+M     …     each array's raw bytes, in manifest order,
                  C-contiguous little-endian, no padding

Decode is strict and TYPED: a bad magic, unknown version, truncated
header/body, oversize/undersize payload, or non-decodable meta raises
:class:`WireError` with ``code="bad_frame"`` — the HTTP layer turns it
into a 400 (a malformed frame is the CLIENT's bug, never a 500). The
version byte is checked before anything else so a future v2 decoder
can answer "version_mismatch" in the error detail rather than
misparsing.

Bit-exactness contract: ``decode(encode(scalars, arrays))`` returns
arrays equal BIT-FOR-BIT (same dtype, same shape, same bytes) — the
property ``tests/test_torch_wire.py`` pins across dtypes/shapes — so an act
that rode the binary path is indistinguishable from the JSON path
after ``np.asarray``. Non-native-endian inputs are byteswapped to
little-endian at encode (the wire format is LE, period); decode views
are read-only (they alias the request body buffer).
"""

from __future__ import annotations

import json
from typing import Dict, Optional, Tuple

import numpy as np

__all__ = [
    "WIRE_CONTENT_TYPE",
    "JSON_CONTENT_TYPE",
    "WIRE_VERSION",
    "WireError",
    "encode_frame",
    "decode_frame",
    "restamp",
    "wants_binary",
    "is_binary_body",
]

# the negotiated media type: requests carry it as Content-Type, a
# client that can READ binary responses says so with Accept
WIRE_CONTENT_TYPE = "application/x-trpo-wire"
JSON_CONTENT_TYPE = "application/json"

WIRE_VERSION = 1
_MAGIC = b"TW"
_HDR = 8  # magic(2) + version(1) + reserved(1) + meta_len(4)

# the dtypes the act/carry plane actually ships; an allowlist keeps a
# hostile manifest from instantiating object/void dtypes out of a
# network payload
_DTYPES = frozenset(
    ["f2", "f4", "f8", "i1", "i2", "i4", "i8",
     "u1", "u2", "u4", "u8", "b1"]
)


class WireError(ValueError):
    """A frame this decoder refuses, with the serving tier's typed
    error ``code`` (``bad_frame``) so the HTTP layer can answer a
    400 body in the same ``{"error", "code"}`` shape as every other
    protocol refusal."""

    def __init__(self, detail: str, code: str = "bad_frame"):
        super().__init__(detail)
        self.code = code
        self.detail = detail


def _le_dtype(arr: np.ndarray) -> np.dtype:
    dt = arr.dtype.newbyteorder("<")
    return dt


def encode_frame(
    scalars: Optional[dict] = None,
    arrays: Optional[Dict[str, np.ndarray]] = None,
) -> bytes:
    """One frame from JSON-able ``scalars`` plus named numpy arrays.

    Arrays are written C-contiguous little-endian (converted as
    needed); scalars must be JSON-serializable (the same restriction
    the JSON path already imposes)."""
    manifest = []
    chunks = []
    for name, arr in (arrays or {}).items():
        a = np.asarray(arr)
        if a.dtype.kind not in "fiub":
            raise WireError(
                f"array {name!r} has unsupported dtype {a.dtype}",
            )
        shape = a.shape  # before ascontiguousarray, which promotes 0-d
        a = np.ascontiguousarray(a, dtype=_le_dtype(a))
        code = f"{a.dtype.kind}{a.dtype.itemsize}"
        manifest.append([name, code, list(shape)])
        chunks.append(a.tobytes())
    meta = json.dumps(
        {"f": scalars or {}, "a": manifest},
        separators=(",", ":"),
    ).encode()
    head = (
        _MAGIC
        + bytes([WIRE_VERSION, 0])
        + len(meta).to_bytes(4, "little")
    )
    return b"".join([head, meta] + chunks)


def decode_frame(buf: bytes) -> Tuple[dict, Dict[str, np.ndarray]]:
    """``(scalars, arrays)`` from one frame; arrays are READ-ONLY
    zero-copy views into ``buf``. Raises :class:`WireError`
    (``code="bad_frame"``) on anything malformed — truncation, bad
    magic, version mismatch, manifest/payload length disagreement."""
    if len(buf) < _HDR:
        raise WireError(
            f"truncated frame: {len(buf)} bytes < {_HDR}-byte header"
        )
    if buf[:2] != _MAGIC:
        raise WireError(f"bad magic {bytes(buf[:2])!r} (want {_MAGIC!r})")
    version = buf[2]
    if version != WIRE_VERSION:
        raise WireError(
            f"version_mismatch: frame v{version}, decoder v{WIRE_VERSION}"
        )
    meta_len = int.from_bytes(buf[4:8], "little")
    if _HDR + meta_len > len(buf):
        raise WireError(
            f"truncated frame: meta wants {meta_len} bytes, "
            f"{len(buf) - _HDR} available"
        )
    try:
        meta = json.loads(buf[_HDR : _HDR + meta_len].decode())
        scalars = meta["f"]
        manifest = meta["a"]
        assert isinstance(scalars, dict) and isinstance(manifest, list)
    except Exception as e:
        raise WireError(f"undecodable meta: {type(e).__name__}") from None
    # a read-only memoryview keeps the array views zero-copy AND
    # prevents a handler from scribbling on the shared request buffer
    body = memoryview(buf)[_HDR + meta_len :].toreadonly()
    arrays: Dict[str, np.ndarray] = {}
    off = 0
    for entry in manifest:
        try:
            name, code, shape = entry
            shape = tuple(int(s) for s in shape)
            if code not in _DTYPES or any(s < 0 for s in shape):
                raise ValueError
            dt = np.dtype(code).newbyteorder("<")
        except Exception:
            raise WireError(
                f"bad manifest entry {entry!r}"
            ) from None
        n = int(np.prod(shape, dtype=np.int64)) * dt.itemsize
        if off + n > len(body):
            raise WireError(
                f"truncated frame: array {name!r} wants {n} bytes at "
                f"offset {off}, {len(body) - off} available"
            )
        arrays[name] = np.frombuffer(
            body[off : off + n], dtype=dt
        ).reshape(shape)
        off += n
    if off != len(body):
        raise WireError(
            f"oversized frame: {len(body) - off} trailing bytes after "
            "the last manifest array"
        )
    return scalars, arrays


def restamp(buf: bytes, **scalars) -> bytes:
    """A copy of ``buf`` with ``scalars`` merged into its scalar
    fields and every array byte UNTOUCHED (one header rewrite + one
    memcpy of the payload) — the router's session-act seq stamping
    without decoding/re-encoding the obs."""
    if len(buf) < _HDR or buf[:2] != _MAGIC or buf[2] != WIRE_VERSION:
        # surface the same typed refusal decode would
        decode_frame(buf)
    meta_len = int.from_bytes(buf[4:8], "little")
    if _HDR + meta_len > len(buf):
        decode_frame(buf)  # raises the precise truncation error
    try:
        meta = json.loads(bytes(buf[_HDR : _HDR + meta_len]).decode())
        meta["f"].update(scalars)
    except WireError:
        raise
    except Exception as e:
        raise WireError(f"undecodable meta: {type(e).__name__}") from None
    new_meta = json.dumps(meta, separators=(",", ":")).encode()
    head = (
        _MAGIC
        + bytes([WIRE_VERSION, 0])
        + len(new_meta).to_bytes(4, "little")
    )
    return b"".join([head, new_meta, buf[_HDR + meta_len :]])


def is_binary_body(headers) -> bool:
    """Did the request declare a binary body? (``headers`` is any
    ``.get``-able mapping or None.)"""
    if headers is None:
        return False
    ctype = headers.get("Content-Type") or ""
    return ctype.split(";", 1)[0].strip().lower() == WIRE_CONTENT_TYPE


def wants_binary(headers) -> bool:
    """Should the response be binary? Binary only when the client
    explicitly listed the wire type in ``Accept`` — or sent a binary
    body and no Accept at all (a wire client reads what it writes);
    everything else (curl, browsers, old clients) stays JSON."""
    if headers is None:
        return False
    accept = headers.get("Accept")
    if accept is not None:
        return any(
            part.split(";", 1)[0].strip().lower() == WIRE_CONTENT_TYPE
            for part in accept.split(",")
        )
    return is_binary_body(headers)
