"""The port's HiDream edit (uce_tpu_torch/edit/hidream.py, ``edit-hidream``)
and its batched per-module solve (ops/solver.py::uce_edit_matrix_batch)
against uce_tpu's, on tests/snapshot.py's tiny HiDream snapshot: the
targets in index order, the per-module concept streams (Llama layers at
llama_layers, then T5), one solve per module held to uce_tpu's and to a
float64 oracle, the errors, and both CLIs writing the same keys and values.
fp32 tolerances: embeddings rtol = atol = 2e-4 (tests/test_unet_cross_impl.py's
module bar); solves rtol = atol = 1e-4 relative to the targets' scale
(tests/test_torch_edit_flux.py), 5e-4 against the float64 oracle
(tests/test_edit_hidream.py)."""

import os

import numpy as np
import pytest
import torch

from tests.torch_threads import one_torch_thread  # noqa: F401
from uce_tpu_torch.edit import hidream as thd_edit
from uce_tpu_torch.ops import solver as tsolver

EDITS, GUIDES, PRESERVES = ["kelly mckernan", "tyler edlin"], ["art", "art"], ["van gogh"]


@pytest.fixture(scope="module")
def hd_snap(tmp_path_factory):
    from tests.snapshot import make_hidream_snapshot

    return make_hidream_snapshot(tmp_path_factory.mktemp("torch_edit_hidream_snap"))


@pytest.fixture(scope="module")
def resources(hd_snap):
    from uce_tpu.edit import hidream as jhd_edit

    return (jhd_edit.load_resources(hd_snap, max_sequence_length=16),
            thd_edit.load_resources(hd_snap, max_sequence_length=16, device="cpu"))


def _stacks(rng, m, k, p, d):
    n = lambda *s: rng.standard_normal(s).astype(np.float32)
    return n(m, k, d), n(m, k, d), (n(m, p, d) if p else None)


@pytest.mark.parametrize("m,k,p,d,scale", [(3, 4, 2, 16, 1.0), (5, 2, 0, 24, 3.0),
                                            (2, 3, 3, 8, [1.0, 2.0, 0.5])])
def test_uce_edit_matrix_batch_matches_uce_tpu(m, k, p, d, scale):
    from uce_tpu.ops import solver as jsolver

    c_e, c_g, c_p = _stacks(np.random.default_rng(m + d), m, k, p, d)
    want = np.asarray(jsolver.uce_edit_matrix_batch(c_e, c_g, c_p, scale, 0.7, 0.3))
    t = lambda a: None if a is None else torch.as_tensor(a)
    got = tsolver.uce_edit_matrix_batch(t(c_e), t(c_g), t(c_p), scale, 0.7, 0.3)
    assert got.shape == (m, d, d) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    # each module is the single-module collapsed solve of its own stacks
    for i in range(m):
        one = tsolver.uce_edit_matrix(t(c_e[i]), t(c_g[i]), None if c_p is None
                                      else t(c_p[i]), scale, 0.7, 0.3)
        np.testing.assert_allclose(got[i].numpy(), one.numpy(), rtol=1e-5, atol=1e-5)


def test_uce_edit_matrix_batch_falls_back_per_module():
    """A negative erase scale makes module 1's mat2 indefinite (its Cholesky
    fails) while module 0's stays SPD: module 1 takes the LU solve, module 0
    keeps the Cholesky one, as uce_tpu's per-module cond does."""
    from uce_tpu.ops import solver as jsolver

    d = 6
    c_e = np.zeros((2, 1, d), np.float32)
    c_e[0, 0, 0], c_e[1, 0, 0] = 0.1, 3.0  # lam - 0.5 * c^2 < 0 in module 1 only
    c_g = np.random.default_rng(0).standard_normal((2, 1, d)).astype(np.float32)
    want = np.asarray(jsolver.uce_edit_matrix_batch(c_e, c_g, None, -0.5, 1.0, 0.5))
    got = tsolver.uce_edit_matrix_batch(torch.as_tensor(c_e), torch.as_tensor(c_g), None,
                                        -0.5, 1.0, 0.5)
    assert bool(torch.isfinite(got).all())
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    mat2 = 0.5 * np.eye(d) - 0.5 * np.outer(c_e[1, 0], c_e[1, 0])
    mat_a = 0.5 * np.eye(d) - 0.5 * np.outer(c_g[1, 0], c_e[1, 0])
    np.testing.assert_allclose(got[1].numpy(), mat_a @ np.linalg.inv(mat2), rtol=1e-4,
                               atol=1e-4)


def test_load_resources_matches_uce_tpu(resources):
    jres, tres = resources
    assert list(tres.targets) == list(jres.targets) == [
        f"caption_projection.{i}.linear.weight" for i in range(3)]
    for key, w in tres.targets.items():
        assert w.dtype == torch.float32 and w.device.type == "cpu"
        np.testing.assert_array_equal(w.numpy(), jres.targets[key])
    assert list(tres.llama_layers) == list(jres.llama_layers) == [0, 1]
    assert tres.max_sequence_length == 16 and tres.llama_tokenizer.pad_id == \
        tres.llama_tokenizer.eos_id


def test_encode_concepts_matches_uce_tpu(resources):
    from uce_tpu.edit import hidream as jhd_edit

    jres, tres = resources
    concepts = EDITS + GUIDES + PRESERVES
    want = jhd_edit.encode_concepts(jres, concepts)
    got = thd_edit.encode_concepts(tres, concepts)
    assert list(got) == list(want) == list(dict.fromkeys(concepts))
    for c in want:
        assert len(got[c]) == len(want[c]) == 3  # 2 llama layers + t5
        for g, w in zip(got[c], want[c]):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-4, atol=2e-4)
    s = got[EDITS[0]]
    assert (s[0] - s[1]).abs().max() > 1e-6 and (s[0] - s[2]).abs().max() > 1e-6


def test_erase_matches_uce_tpu_and_per_module_oracle(resources):
    """The same (uce_tpu's) embeddings through both solvers; each module
    against a float64 solve of its own stream's embeddings."""
    from uce_tpu.edit import hidream as jhd_edit

    jres, tres = resources
    embeds = jhd_edit.encode_concepts(jres, EDITS + GUIDES + PRESERVES)
    want = jhd_edit.erase_from_embeddings(jres.targets, embeds, EDITS, GUIDES, PRESERVES,
                                          erase_scale=2.0, lamb=0.3)
    t_embeds = {c: [torch.tensor(np.array(v)) for v in e] for c, e in embeds.items()}
    got = thd_edit.erase_from_embeddings(tres.targets, t_embeds, EDITS, GUIDES, PRESERVES,
                                         erase_scale=2.0, lamb=0.3, device="cpu")
    assert list(got) == list(want)
    for m, (key, w) in enumerate(tres.targets.items()):
        scale = float(np.abs(want[key]).max())
        np.testing.assert_allclose(got[key].numpy() / scale, want[key] / scale,
                                   rtol=1e-4, atol=1e-4)
        w64 = w.double().numpy()
        d = w64.shape[1]
        e = lambda cs: np.stack([np.asarray(embeds[c][m], np.float64) for c in cs])
        mat2 = 0.3 * np.eye(d) + 2.0 * e(EDITS).T @ e(EDITS) + e(PRESERVES).T @ e(PRESERVES)
        mat_a = 0.3 * np.eye(d) + 2.0 * e(GUIDES).T @ e(EDITS) + e(PRESERVES).T @ e(PRESERVES)
        np.testing.assert_allclose(got[key].numpy(), w64 @ mat_a @ np.linalg.inv(mat2),
                                   rtol=5e-4, atol=5e-4, err_msg=key)
        assert not np.allclose(got[key].numpy(), jres.targets[key])  # edited


def test_stream_count_mismatch_and_module_order(resources):
    tres = resources[1]
    bad = {"x": [torch.zeros(16)] * 2}  # 2 streams for 3 modules
    with pytest.raises(ValueError, match="embedding streams"):
        thd_edit.erase_from_embeddings(tres.targets, bad, ["x"], ["x"], [], device="cpu")
    keys = [f"caption_projection.{i}.linear.weight" for i in (10, 2, 0, 1)]
    assert sorted(keys, key=thd_edit.module_index) == [
        f"caption_projection.{i}.linear.weight" for i in (0, 1, 2, 10)]
    with pytest.raises(ValueError, match="cannot parse"):
        thd_edit.module_index("context_embedder.weight")


def test_missing_llama_and_real_tokenizer_files(tmp_path):
    """No llama_dir and no text_encoder_4: the 'pass llama_dir' error before
    any file is read; a Llama directory with only spiece.model is refused by
    name; one with only tokenizer.json is read, padding with eos."""
    from tests.torch_tokenizer_files import write_llama_tokenizer
    from uce_tpu_torch.models.hf_tokenizer import HFTokenizer

    with pytest.raises(ValueError, match="llama_dir"):
        thd_edit.load_resources(str(tmp_path / "nonexistent"), llama_dir=None, device="cpu")
    (tmp_path / "spiece.model").write_bytes(b"\x00")
    with pytest.raises(NotImplementedError, match="spiece.model but no tokenizer.json"):
        thd_edit.load_llama_tokenizer(str(tmp_path))
    write_llama_tokenizer(str(tmp_path), vocab_size=300)
    tok = thd_edit.load_llama_tokenizer(str(tmp_path))
    assert isinstance(tok, HFTokenizer) and tok.pad_token == "<|eot_id|>"
    ids, mask = tok(["a cat"], max_length=8)["input_ids"], tok(["a cat"], max_length=8)[
        "attention_mask"]
    assert ids[0, 0] == tok.token_to_id("<|begin_of_text|>") and mask[0].sum() < 8
    assert (ids[0, mask[0] == 0] == tok.pad_id).all()


def test_edit_hidream_cli_matches_uce_tpu(hd_snap, tmp_path, monkeypatch):
    """Both CLIs' edit-hidream write the same caption-projection keys; the
    values agree to fp32 round-off; --method pallas is refused."""
    from safetensors.numpy import load_file

    from uce_tpu.cli.main import main as jmain
    from uce_tpu_torch.cli.main import main as tmain

    # uce_tpu's main() would point this worker's XLA cache at ~/.cache for
    # the rest of the process (tests/test_compile_cache.py then misses)
    monkeypatch.setenv("UCE_COMPILE_CACHE", "0")

    args = ["edit-hidream", "--model_id", hd_snap, "--edit_concepts",
            "kelly mckernan; tyler edlin", "--concept_type", "art",
            "--preserve_concepts", "van gogh", "--exp_name", "erase",
            "--max_sequence_length", "16"]
    assert jmain(args + ["--save_dir", str(tmp_path / "jax")]) == 0
    assert tmain(args + ["--save_dir", str(tmp_path / "torch"), "--device", "cpu"]) == 0
    want = load_file(str(tmp_path / "jax" / "erase.safetensors"))
    got = load_file(str(tmp_path / "torch" / "erase.safetensors"))
    assert sorted(got) == sorted(want) == [
        f"caption_projection.{i}.linear.weight" for i in range(3)]
    for k in want:
        assert got[k].shape == want[k].shape and got[k].dtype == np.float32
        scale = float(np.abs(want[k]).max())
        np.testing.assert_allclose(got[k] / scale, want[k] / scale, rtol=1e-4, atol=1e-4)
    with pytest.raises(SystemExit, match="not supported for HiDream"):
        tmain(args + ["--save_dir", str(tmp_path / "refused"), "--device", "cpu",
                      "--method", "pallas"])
    assert not os.path.exists(tmp_path / "refused")
