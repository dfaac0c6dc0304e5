"""The port's wire codec (``trpo_torch/serve/wire.py``) against the
reference's (``trpo_tpu/serve/wire.py``): the same inputs give
byte-identical frames for every dtype of ``tests/test_wire.py``, and each
package decodes the other's frames bit for bit, malformed ones included.
"""

import numpy as np
import pytest

from trpo_torch.serve import wire as port_wire
from trpo_tpu.serve import wire as ref_wire

DTYPES = ["f2", "f4", "f8", "i1", "i2", "i4", "i8",
          "u1", "u2", "u4", "u8", "b1"]


def _array(dtype: str) -> np.ndarray:
    rng = np.random.RandomState(3)
    dt = np.dtype(dtype)
    if dt.kind == "f":
        return rng.randn(2, 3).astype(dt)
    if dt.kind == "b":
        return rng.randn(2, 3) > 0
    return rng.randint(0, 100, size=(2, 3)).astype(dt)


@pytest.mark.parametrize("dtype", DTYPES)
def test_frames_byte_identical_and_cross_decoded(dtype):
    arr = _array(dtype)
    scalars = {"seq": 7, "session": "abc", "step": None}
    frame = port_wire.encode_frame(scalars, {"x": arr, "y": arr.T})
    assert frame == ref_wire.encode_frame(scalars, {"x": arr, "y": arr.T})
    for decode in (port_wire.decode_frame, ref_wire.decode_frame):
        got_scalars, arrays = decode(frame)
        assert got_scalars == scalars
        for name, want in (("x", arr), ("y", arr.T)):
            out = arrays[name]
            assert out.dtype.newbyteorder("=") == np.dtype(dtype)
            assert out.shape == want.shape
            assert out.tobytes() == np.ascontiguousarray(want).tobytes()


def test_big_endian_scalar_and_empty_arrays_match():
    arrays = {
        "be": np.arange(6, dtype=">f4").reshape(2, 3),
        "scalar0d": np.float32(2.5),
        "empty": np.zeros((0, 4), np.float32),
        "pixels": np.arange(84 * 84 * 4, dtype=np.uint8).reshape(84, 84, 4),
    }
    frame = port_wire.encode_frame({"a": 1}, arrays)
    assert frame == ref_wire.encode_frame({"a": 1}, arrays)
    _, out = ref_wire.decode_frame(frame)
    assert list(out) == list(arrays)
    np.testing.assert_array_equal(out["be"], arrays["be"].astype("<f4"))


@pytest.mark.parametrize("frame", [
    b"",
    b"TW",
    b"XX\x01\x00\x00\x00\x00\x00",
    b"TW\x02\x00\x02\x00\x00\x00{}",
    b"TW\x01\x00\xff\xff\xff\xff{}",
    b"TW\x01\x00\x05\x00\x00\x00nope!",
])
def test_malformed_frames_refused_alike(frame):
    with pytest.raises(port_wire.WireError) as port_err:
        port_wire.decode_frame(frame)
    with pytest.raises(ref_wire.WireError) as ref_err:
        ref_wire.decode_frame(frame)
    assert port_err.value.code == ref_err.value.code == "bad_frame"


def test_negotiation_helpers_agree():
    wire_t, json_t = port_wire.WIRE_CONTENT_TYPE, port_wire.JSON_CONTENT_TYPE
    assert (wire_t, json_t) == (ref_wire.WIRE_CONTENT_TYPE,
                                ref_wire.JSON_CONTENT_TYPE)
    for headers in (None, {}, {"Content-Type": wire_t},
                    {"Content-Type": json_t}, {"Accept": wire_t},
                    {"Content-Type": wire_t, "Accept": json_t},
                    {"Content-Type": f"{wire_t}; v=1"}):
        assert port_wire.is_binary_body(headers) == \
            ref_wire.is_binary_body(headers)
        assert port_wire.wants_binary(headers) == \
            ref_wire.wants_binary(headers)
