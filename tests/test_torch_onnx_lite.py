"""The port's ONNX initializer reader (uce_tpu_torch/utils/onnx_lite.py)
against uce_tpu's on the hand-encoded protos of tests/test_yolo.py: dims
packed or not, raw or typed data, and an int64 tensor."""

import numpy as np
import pytest

from tests.test_yolo import _field, _onnx_bytes, _varint
from tests.torch_threads import one_torch_thread  # noqa: F401
from uce_tpu.utils.onnx_lite import read_initializers as uce_read
from uce_tpu_torch.utils.onnx_lite import read_initializers


def _tensors(seed):
    rng = np.random.default_rng(seed)
    return {"model.0.conv.weight": rng.normal(size=(4, 3, 3, 3)).astype(np.float32),
            "model.0.conv.bias": rng.normal(size=(4,)).astype(np.float32)}


@pytest.mark.parametrize("packed_dims,use_raw", [(True, True), (False, True), (True, False)])
def test_reader_matches_uce_tpus(packed_dims, use_raw, tmp_path):
    tensors = _tensors(4)
    data = _onnx_bytes(tensors, packed_dims=packed_dims, use_raw=use_raw)
    path = tmp_path / "m.onnx"
    path.write_bytes(data)
    want = uce_read(data)
    for got in (read_initializers(data), read_initializers(str(path))):
        assert got.keys() == want.keys() == tensors.keys()
        for k in tensors:
            assert got[k].dtype == want[k].dtype == np.float32
            np.testing.assert_array_equal(got[k], want[k])
            np.testing.assert_array_equal(got[k], tensors[k])


def test_int64_and_malformed_match_uce_tpus():
    """An int64_data tensor (varint-packed) reads alike; a file without a
    graph fails alike."""
    dims = _field(1, 2, _varint(3))
    ints = _field(7, 2, b"".join(_varint(v) for v in (1, 300, 2 ** 40)))
    proto = dims + _field(2, 0, _varint(7)) + _field(8, 2, b"shape") + ints
    data = _field(7, 2, _field(5, 2, proto))
    got, want = read_initializers(data), uce_read(data)
    assert got["shape"].dtype == want["shape"].dtype == np.int64
    np.testing.assert_array_equal(got["shape"], want["shape"])
    with pytest.raises(ValueError) as w:
        uce_read(_field(1, 0, _varint(8)))
    with pytest.raises(ValueError) as g:
        read_initializers(_field(1, 0, _varint(8)))
    assert str(g.value) == str(w.value)
