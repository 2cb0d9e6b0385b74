"""The port's T5 encoder (uce_tpu_torch/models/t5.py) against uce_tpu's on
the same seeded weights (carried across by models/convert.py::t5_params or
read from tests/snapshot.py's FLUX snapshot): the relative position
buckets, and the encoder with and without an attention mask, gated-GELU
(v1.1, FLUX's T5-XXL) and ReLU. fp32 tolerance of
tests/test_unet_cross_impl.py: rtol = atol = 2e-4."""

import json
import os

import numpy as np
import pytest
import torch

from tests.torch_threads import one_torch_thread  # noqa: F401
from uce_tpu_torch.models import convert, t5 as tt5

TOL = dict(rtol=2e-4, atol=2e-4)


def _configs(gated: bool):
    from uce_tpu.models import t5 as jt5

    kw = dict(vocab_size=99, d_model=16, d_kv=4, d_ff=32, num_layers=2, num_heads=4,
              relative_attention_num_buckets=8, relative_attention_max_distance=16,
              is_gated_act=gated, dense_act_fn="gelu_new" if gated else "relu")
    return jt5.T5Config(**kw), tt5.T5Config(**kw)


@pytest.mark.parametrize("q_len,buckets,max_distance", [(16, 8, 16), (256, 32, 128),
                                                        (77, 32, 128)])
def test_relative_position_buckets_equal(q_len, buckets, max_distance):
    from uce_tpu.models import t5 as jt5

    want = jt5.relative_position_buckets(q_len, q_len, buckets, max_distance)
    got = tt5.relative_position_buckets(q_len, q_len, buckets, max_distance)
    np.testing.assert_array_equal(got, want)
    assert got.min() >= 0 and got.max() < buckets


@pytest.mark.parametrize("gated", [True, False], ids=["gated_gelu", "relu"])
@pytest.mark.parametrize("masked", [False, True], ids=["no_mask", "mask"])
def test_encode_tokens_matches_uce_tpu(gated, masked):
    import jax.numpy as jnp

    from uce_tpu.models import t5 as jt5

    jcfg, tcfg = _configs(gated)
    jparams = jt5.init_params(np.random.default_rng(1), jcfg)
    tparams = convert.t5_params(jparams, tcfg)
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 99, (2, 20))
    mask = None
    if masked:
        mask = np.ones((2, 20), np.int64)
        mask[1, 11:] = 0
    want = np.asarray(jt5.encode_tokens(jparams, jnp.asarray(ids),
                                        None if mask is None else jnp.asarray(mask), jcfg))
    got = tt5.encode_tokens(tparams, torch.as_tensor(ids),
                            None if mask is None else torch.as_tensor(mask), tcfg)
    assert got.dtype == torch.float32 and got.shape == (2, 20, 16)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.fixture(scope="module")
def flux_snap(tmp_path_factory):
    from tests.snapshot import make_flux_snapshot

    return make_flux_snapshot(tmp_path_factory.mktemp("torch_t5_snap"))


def test_snapshot_encoder_matches_uce_tpu(flux_snap):
    """The snapshot's text_encoder_2 (HF keys, ReLU) read by both packages."""
    import jax.numpy as jnp

    from uce_tpu.models import t5 as jt5
    from uce_tpu.models.hf_loader import load_state_dict as jload
    from uce_tpu_torch.edit.flux import load_t5_encoder

    hf = json.load(open(os.path.join(flux_snap, "text_encoder_2", "config.json")))
    jcfg = jt5.T5Config.from_hf(hf)
    jparams = jt5.convert_hf_state_dict(
        jload(flux_snap, "text_encoder_2", dtype=np.float32), jcfg)
    tparams, tcfg = load_t5_encoder(flux_snap, device="cpu")
    assert tcfg == tt5.T5Config(**{f: getattr(jcfg, f) for f in jcfg.__dataclass_fields__})
    assert tt5.T5Config.from_hf(tcfg.to_hf()) == tcfg
    ids = np.random.default_rng(2).integers(0, tcfg.vocab_size, (3, 24))
    want = np.asarray(jt5.encode_tokens(jparams, jnp.asarray(ids), None, jcfg))
    got = tt5.encode_tokens(tparams, torch.as_tensor(ids), None, tcfg)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("gated", [True, False], ids=["gated_gelu", "relu"])
def test_init_state_dict_key_contract(flux_snap, gated):
    """init_state_dict writes the keys and shapes that the snapshot writer
    writes (HF T5EncoderModel), drawn on the device asked for, and the HF
    reader takes them."""
    from uce_tpu_torch.models.hf_loader import load_state_dict

    cfg = tt5.T5Config.from_hf(json.load(open(
        os.path.join(flux_snap, "text_encoder_2", "config.json"))))
    sd = tt5.init_state_dict(cfg, seed=0, device="cpu", dtype=torch.float32)
    if not gated:
        want = load_state_dict(flux_snap, "text_encoder_2")
        assert {k: tuple(v.shape) for k, v in sd.items()} == {
            k: tuple(v.shape) for k, v in want.items()}
    cfg = tt5.T5Config(**{**cfg.__dict__, "is_gated_act": gated,
                          "dense_act_fn": "gelu_new" if gated else "relu"})
    sd = tt5.init_state_dict(cfg, seed=0, device="cpu", dtype=torch.float32)
    assert all(v.device.type == "cpu" for v in sd.values())
    params = tt5.convert_hf_state_dict(sd, cfg)
    assert set(params["layers"][0]) == (
        {"ln1", "q", "k", "v", "o", "ln2", "wo"} | ({"wi_0", "wi_1"} if gated else {"wi"}))
    out = tt5.encode_tokens(params, torch.zeros(1, 8, dtype=torch.long), None, cfg)
    assert torch.isfinite(out).all()
    again = tt5.init_state_dict(cfg, seed=0, device="cpu", dtype=torch.float32)
    assert all(torch.equal(sd[k], again[k]) for k in sd)


@pytest.mark.parametrize("files", [("spiece.model",), ("spiece.model", "tokenizer.json")])
def test_t5_tokenizer_json_is_read_and_spiece_alone_refused(tmp_path, files):
    """A tokenizer_2 holding only SentencePiece's spiece.model is refused
    by name; with a tokenizer.json beside it, that file is read and gives
    AutoTokenizer's ids."""
    from transformers import AutoTokenizer

    from tests.torch_tokenizer_files import write_t5_tokenizer
    from uce_tpu_torch.edit.flux import load_t5_tokenizer
    from uce_tpu_torch.models.hf_tokenizer import HFTokenizer

    path = tmp_path / "tokenizer_2"
    path.mkdir()
    (path / "spiece.model").write_bytes(b"\x00")
    if "tokenizer.json" not in files:
        with pytest.raises(NotImplementedError, match="spiece.model but no tokenizer.json"):
            load_t5_tokenizer(str(tmp_path))
        return
    write_t5_tokenizer(str(path), vocab_size=200)
    tok = load_t5_tokenizer(str(tmp_path))
    assert isinstance(tok, HFTokenizer)
    texts = ["a photo of an astronaut", "Ａ ﬁsh <extra_id_7>"]
    want = AutoTokenizer.from_pretrained(str(path))(texts, padding="max_length", max_length=32,
                                                     truncation=True, return_tensors="np")
    got = tok(texts, padding="max_length", max_length=32, truncation=True, return_tensors="np")
    np.testing.assert_array_equal(got["input_ids"], want["input_ids"])
    np.testing.assert_array_equal(got["attention_mask"], want["attention_mask"])
