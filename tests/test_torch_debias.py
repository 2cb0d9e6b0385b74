"""The port's debias loop (uce_tpu_torch/edit/debias.py, ``debias-sd``)
against uce_tpu's: the controller on a linear plant, the collapsed re-solve
(within 1e-4 relative / 1e-5 absolute: fp32 solves of the same system in
another library), the device path bit for bit against the host path, and
``run_debias`` end to end on the tiny SD and CLIP snapshots of
tests/snapshot.py (the same observed ratios at every iteration, the final
weights within the solver tolerance)."""

import csv

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.snapshot import make_clip_snapshot, make_sd_snapshot
from tests.torch_threads import one_torch_thread  # noqa: F401
from uce_tpu_torch.diffusion.pipeline import SDPipeline
from uce_tpu_torch.edit import debias
from uce_tpu_torch.edit.debias import (DebiasSettings, DeviceDebiasApplier,
                                       apply_deadband, debias_loop,
                                       make_collapsed_solver, resources_from_pipe,
                                       run_debias)
from uce_tpu_torch.models import unet as unet_mod
from uce_tpu_torch.models.hf_loader import read_safetensors

SOLVE_TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(scope="module")
def snaps(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_debias")
    return make_sd_snapshot(root / "sd"), make_clip_snapshot(root / "clip")


def _pipe(snap, dtype=torch.float32):
    return SDPipeline.from_pretrained(snap, dtype=dtype, device="cpu")


# ----------------------------------------------------------- controller
@pytest.mark.parametrize("ratios,max_diff", [
    ([[0.04, -0.03], [0.2, -0.2]], 0.05), ([[0.05, -0.01]], 0.05),
    ([[0.0, -0.049], [-0.3, 0.01], [0.1, 0.1]], 0.05), ([[0.2, -0.2]], 0.25)])
def test_deadband_matches_uce_tpu(ratios, max_diff):
    from uce_tpu.edit.debias import apply_deadband as japply

    r = np.asarray(ratios)
    np.testing.assert_array_equal(apply_deadband(r, max_diff), japply(r, max_diff))


def test_controller_converges_on_linear_plant():
    """Observed ratios respond linearly (gain 0.4) to the accumulated
    coefficient from a biased start: the loop reaches the deadband, and its
    trajectory is uce_tpu's."""
    from uce_tpu.edit.debias import debias_loop as jloop

    desired, start = np.array([0.5, 0.5]), np.array([[0.9, 0.1], [0.3, 0.7]])

    def run(loop):
        return loop(lambda acc: {"acc": acc.copy()},
                    lambda w: np.clip(start + 0.4 * w["acc"], 0, 1), 2, 2, desired,
                    max_iterations=30, max_diff=0.05)

    _, acc, history = run(debias_loop)
    _, jacc, jhistory = run(jloop)
    assert np.abs(history[-1]["observed"] - desired).max() < 0.05 + 0.4 * 0.05
    assert history[-1]["ratios"].max() == 0 and len(history) < 30
    np.testing.assert_array_equal(acc, jacc)
    assert len(history) == len(jhistory)
    for h, j in zip(history, jhistory):
        np.testing.assert_array_equal(h["observed"], j["observed"])


def test_controller_accumulates_across_iterations():
    calls = []
    debias_loop(lambda acc: calls.append(acc.copy()), lambda _: np.array([[0.0, 1.0]]),
                1, 2, np.array([1.0, 0.0]), 3, 0.05)
    np.testing.assert_array_equal(np.stack(calls), [[[0, 0]], [[1, -1]], [[2, -2]],
                                                    [[3, -3]]])


# -------------------------------------------------------------- solvers
def _solver_inputs(seed=0, d=16):
    rng = np.random.default_rng(seed)
    targets = {f"b{i}.attn2.to_{p}.weight": rng.standard_normal((o, d)).astype(np.float32)
               for i, o in enumerate((24, 8)) for p in "kv"}
    embeds = {c: rng.standard_normal(d).astype(np.float32)
              for c in ("doctor", "nurse", "male", "female", "chef")}
    return targets, embeds


@pytest.mark.parametrize("acc", [[[0.0, 0.0], [0.0, 0.0]], [[0.3, -0.2], [1.1, 0.4]],
                                 [[-1.4, 2.1], [0.05, -0.7]]])
@pytest.mark.parametrize("preserve", [[], ["chef"]])
def test_collapsed_solver_matches_uce_tpu(acc, preserve):
    from uce_tpu.edit.debias import make_collapsed_solver as jmake

    targets, embeds = _solver_inputs()
    settings = DebiasSettings(edit_scale=2.0, preserve_scale=0.5, lamb=0.7)
    args = (["doctor", "nurse"], ["male", "female"], preserve, settings)
    want = jmake(targets, embeds, *args)(np.asarray(acc))
    got = make_collapsed_solver({k: torch.from_numpy(v) for k, v in targets.items()},
                                {k: torch.from_numpy(v) for k, v in embeds.items()},
                                *args)(np.asarray(acc))
    assert list(got) == list(want)
    for k in want:
        assert got[k].device.type == "cpu" and got[k].dtype == torch.float32
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), **SOLVE_TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_device_path_bitwise_matches_host_path(snaps, dtype):
    """DeviceDebiasApplier (targets uploaded once, re-solve, W @ E and the
    cast on the device) against make_collapsed_solver + overlay_edits: the
    same weights and the same UNet params, bit for bit."""
    pipe = _pipe(snaps[0], dtype)
    res = resources_from_pipe(pipe)
    edit, attrs, pres = ["doctor"], ["male", "female"], ["nurse"]
    embeds = res.encode_concepts(edit + attrs + pres)
    settings = DebiasSettings()
    base = pipe.unet_params
    applier = DeviceDebiasApplier(res.targets, embeds, edit, attrs, pres, settings, base)
    host_solve = make_collapsed_solver(res.targets, embeds, edit, attrs, pres, settings)
    for acc in (np.zeros((1, 2)), np.array([[0.7, -0.3]]), np.array([[-1.4, 2.1]])):
        host_w, dev_w = host_solve(acc), applier.export(acc)
        assert list(host_w) == list(dev_w) == list(res.targets)
        for k in host_w:
            assert torch.equal(host_w[k], dev_w[k]), k
        host_params = unet_mod.overlay_edits(base, host_w, dtype=pipe.dtype)
        dev_params = applier.overlay(base, acc)
        assert host_params.keys() == dev_params.keys()
        for k in host_params:
            assert host_params[k].dtype == dev_params[k].dtype
            assert torch.equal(host_params[k], dev_params[k]), k


def test_quantized_target_raises(snaps):
    """uce_tpu's applier skips a quantized target silently; the port's
    raises (its float edit would leave the quantized weight in place), and
    so does resources_from_pipe on a quantized pipeline."""
    pipe = _pipe(snaps[0])
    res = resources_from_pipe(pipe)
    embeds = res.encode_concepts(["doctor", "male", "female"])
    pipe.quantize_weights("w8")
    with pytest.raises(ValueError, match="quantized"):
        DeviceDebiasApplier(res.targets, embeds, ["doctor"], ["male", "female"], [],
                            DebiasSettings(), pipe.unet_params)
    with pytest.raises(ValueError, match="quantized"):
        resources_from_pipe(pipe)


def test_measure_seeds_match_uce_tpu():
    from uce_tpu.edit.debias import debias_measure_seeds as jseeds

    concepts = ["doctor", "nurse", "a photo of a chef", "doctor"]
    assert debias.debias_measure_seeds(concepts) == jseeds(concepts)


def test_ratio_length_checked_before_generating(snaps):
    pipe = _pipe(snaps[0])
    with pytest.raises(ValueError, match="desired_ratios"):
        run_debias(pipe, None, ["doctor"], ["white", "black", "asian"],
                   settings=DebiasSettings())  # default: 2 ratios


# ---------------------------------------------------------- end to end
def test_run_debias_matches_uce_tpu(snaps, tmp_path):
    """Real generation and real CLIP classification on both sides (fp32):
    identical observed ratios and accumulated coefficients at every
    iteration, final weights within the solver tolerance; telemetry and the
    safetensors artifact."""
    from uce_tpu.diffusion.pipeline import SDPipeline as JaxPipeline
    from uce_tpu.edit.debias import DebiasSettings as JaxSettings
    from uce_tpu.edit.debias import run_debias as jrun
    from uce_tpu.models.clip import CLIPModel as JaxClip
    from uce_tpu_torch.models.clip import CLIPModel

    sd_snap, clip_snap = snaps
    kw = dict(num_images_per_prompt=6, num_inference_steps=2, max_iterations=2,
              desired_ratios=(0.5, 0.5))
    common = dict(hypothesis_template="{}", image_size=32, verbose=False)
    # two labels whose logits the tiny random CLIP separates by the images
    # (found by a search over letter triples), so the measurement is not
    # constant over the images
    concepts = (["doctor", "nurse"], ["nfu", "nxy"], ["chef"])
    jw, jacc, jhist = jrun(JaxPipeline.from_pretrained(sd_snap, dtype=jnp.float32),
                           JaxClip.from_pretrained(clip_snap), *concepts,
                           settings=JaxSettings(**kw), **common)
    w, acc, hist = run_debias(_pipe(sd_snap), CLIPModel.from_pretrained(clip_snap,
                                                                        device="cpu"),
                              *concepts, settings=DebiasSettings(**kw),
                              save_dir=str(tmp_path), exp_name="deb",
                              telemetry_path=str(tmp_path / "telemetry.csv"), **common)
    assert len(hist) == len(jhist) >= 2
    assert any(((0 < h["observed"]) & (h["observed"] < 1)).any()
               for h in hist)  # a fractional measurement
    for h, j in zip(hist, jhist):
        np.testing.assert_array_equal(h["observed"], j["observed"])
        np.testing.assert_array_equal(h["ratios"], j["ratios"])
        assert set(h["seconds"]) == {"solve", "send", "generate", "classify"}
    np.testing.assert_array_equal(acc, jacc)
    assert list(w) == list(jw)
    for k in w:
        np.testing.assert_allclose(w[k].numpy(), np.asarray(jw[k]), **SOLVE_TOL)
    saved = read_safetensors(str(tmp_path / "deb.safetensors"))
    assert saved.keys() == w.keys() and all(torch.equal(saved[k], w[k]) for k in w)
    with open(tmp_path / "telemetry.csv") as f:
        rows = list(csv.reader(f))
    assert rows[0] == ["iteration", "concept", "observed_nfu", "observed_nxy",
                       "ratio_nfu", "ratio_nxy"]
    assert len(rows) == 1 + 2 * len(hist)


def test_debias_cli_both_applier_paths_agree(snaps, tmp_path):
    """``debias-sd --fast`` on the CPU (bf16 pipeline) with
    --device_resident true and false: the same safetensors bit for bit,
    diffusers keys, and a telemetry row per (iteration, concept)."""
    from uce_tpu_torch.cli.main import main as cli_main

    sd_snap, clip_snap = snaps
    saved = {}
    for resident in ("true", "false"):
        argv = ["debias-sd", "--model_id", sd_snap, "--clip_model_id", clip_snap,
                "--edit_concepts", "doctor; nurse", "--debias_concepts", "male; female",
                "--num_images_per_prompt", "1", "--num_inference_steps", "3",
                "--max_iterations", "2", "--max_diff", "0", "--image_size", "32",
                "--save_dir", str(tmp_path), "--exp_name", f"deb_{resident}",
                "--telemetry_path", str(tmp_path / f"tel_{resident}.csv"),
                "--device_resident", resident, "--step_size", "0.3",
                "--fast", "cfg_interval=1:2,cache=2", "--device", "cpu"]
        assert cli_main(argv) == 0
        saved[resident] = read_safetensors(str(tmp_path / f"deb_{resident}.safetensors"))
        with open(tmp_path / f"tel_{resident}.csv") as f:
            assert len(list(csv.reader(f))) == 1 + 2 * 2
    assert saved["true"].keys() == saved["false"].keys()
    assert all(k.endswith(("attn2.to_k.weight", "attn2.to_v.weight")) for k in saved["true"])
    for k in saved["true"]:
        assert torch.equal(saved["true"][k], saved["false"][k]), k


def test_debias_cli_rejects_mesh_and_ratio_mismatch(snaps, monkeypatch):
    """A mesh spec that does not parse, or a mesh whose ranks cannot start,
    fails the command before the loop (no one-rank fallback); so does a
    ratio list of the wrong length."""
    from uce_tpu_torch.cli import debias_cmd
    from uce_tpu_torch.cli.main import main as cli_main
    from uce_tpu_torch.parallel import workers

    base = ["debias-sd", "--model_id", snaps[0], "--clip_model_id", snaps[1],
            "--edit_concepts", "doctor", "--debias_concepts", "male; female",
            "--device", "cpu"]
    with pytest.raises(ValueError, match="unknown --mesh key"):
        cli_main(base + ["--mesh", "chips=2"])
    with pytest.raises(ValueError, match="model=M must be >= 1"):
        cli_main(base + ["--mesh", "data=2,model=0"])

    def no_ranks(mesh):
        raise RuntimeError("the mesh's ranks did not start")

    loops = []
    monkeypatch.setattr(workers, "start", no_ranks)
    monkeypatch.setattr(debias_cmd, "_run", lambda *a: loops.append(a))
    with pytest.raises(RuntimeError, match="did not start"):
        cli_main(base + ["--mesh", "data=2"])
    assert loops == []
    with pytest.raises(SystemExit, match="do not match"):
        cli_main(base + ["--desired_ratios", "0.3", "0.3", "0.4"])


MESH_KW = dict(num_images_per_prompt=3, num_inference_steps=2, max_iterations=2,
               desired_ratios=(0.5, 0.5))
MESH_CONCEPTS = (["doctor", "nurse"], ["nfu", "nxy"], ["chef"])


@pytest.fixture(scope="module")
def one_rank_debias(snaps):
    """The one-rank port run and its CLIP model, which the mesh runs are
    held to."""
    from uce_tpu_torch.models.clip import CLIPModel

    clip = CLIPModel.from_pretrained(snaps[1], device="cpu")
    return clip, run_debias(_pipe(snaps[0]), clip, *MESH_CONCEPTS,
                            settings=DebiasSettings(**MESH_KW),
                            hypothesis_template="{}", image_size=32, verbose=False)


@pytest.mark.parametrize("n_data,n_model", [(2, 1), (1, 2)], ids=["data2", "model2"])
def test_debias_mesh_matches_one_rank_and_uce_tpu(snaps, one_rank_debias, tmp_path,
                                                  n_data, n_model):
    """``run_debias`` on a meshed pipeline (spawned gloo CPU ranks): at data=2
    the one-rank weights, acc and ratio history bit for bit, at model=2 the
    weights within SOLVE_TOL; after the loop every rank's K/V tensors are
    its shards of the saved weights; uce_tpu's meshed run_debias (the same
    mesh shape on its 8-device CPU mesh, on its host path) sees the same
    observed ratios and saves weights within SOLVE_TOL. Then ``debias-sd --mesh`` with the host
    re-solve writes diffusers keys, as one rank does."""
    import jax
    import jax.numpy as jnp

    from uce_tpu.diffusion.pipeline import SDPipeline as JaxPipeline
    from uce_tpu.edit.debias import DebiasSettings as JaxSettings
    from uce_tpu.edit.debias import run_debias as jrun
    from uce_tpu.models.clip import CLIPModel as JaxClip
    from uce_tpu.parallel import mesh as jmesh
    from uce_tpu_torch.cli.main import main as cli_main
    from uce_tpu_torch.parallel import mesh as tmesh, workers

    sd_snap, clip_snap = snaps
    clip, (w1, acc1, hist1) = one_rank_debias
    common = dict(hypothesis_template="{}", image_size=32, verbose=False)
    pipe = _pipe(sd_snap)
    mesh = tmesh.make_mesh(n_data, n_model, devices="cpu", store_dir=str(tmp_path))
    pipe.apply_mesh(mesh)
    try:
        w, acc, hist = run_debias(pipe, clip, *MESH_CONCEPTS,
                                  settings=DebiasSettings(**MESH_KW), **common)
        shards = workers.held_values("unet", w, pipe.unet_params)
        layout = tmesh.layout_fn("unet", pipe.unet_config, n_model)
    finally:
        pipe.apply_mesh(None)
    assert len(hist) == len(hist1) == 2
    for h, h1 in zip(hist, hist1):
        np.testing.assert_array_equal(h["observed"], h1["observed"])
        np.testing.assert_array_equal(h["ratios"], h1["ratios"])
        assert set(h["seconds"]) == {"solve", "send", "generate", "classify"}
    np.testing.assert_array_equal(acc, acc1)
    assert list(w) == list(w1) and len(w) == len(shards[0]) > 0
    for k in w:
        if n_model == 1:
            assert torch.equal(w[k], w1[k]), k
        else:
            np.testing.assert_allclose(w[k].numpy(), w1[k].numpy(), **SOLVE_TOL)
    for rank, got in enumerate(shards):
        m = mesh.coords(rank)[1]
        for k, t in got.items():
            lay = layout(k, w[k]) if n_model > 1 else None
            assert torch.equal(t, tmesh.shard_value(w[k], lay, m)), (rank, k)
    # the whole UNet is back on rank 0 and takes the saved weights as they are
    for k in w:
        assert torch.equal(pipe.unet_params[k], w[k]), k

    jpipe = JaxPipeline.from_pretrained(sd_snap, dtype=jnp.float32)
    jpipe.apply_mesh(jmesh.make_mesh(n_data, n_model, devices=jax.devices()[:2]))
    # uce_tpu's device-resident swap commits the new leaves to one device,
    # which its data-parallel generate then refuses: its host path
    jw, jacc, jhist = jrun(jpipe, JaxClip.from_pretrained(clip_snap), *MESH_CONCEPTS,
                           settings=JaxSettings(**MESH_KW), device_resident=False, **common)
    assert len(jhist) == len(hist)
    for h, j in zip(hist, jhist):
        np.testing.assert_array_equal(h["observed"], j["observed"])
        np.testing.assert_array_equal(h["ratios"], j["ratios"])
    for k in w:
        np.testing.assert_allclose(w[k].numpy(), np.asarray(jw[k]), **SOLVE_TOL)

    saved = {}
    for spec in (None, f"data={n_data},model={n_model}"):
        argv = ["debias-sd", "--model_id", sd_snap, "--clip_model_id", clip_snap,
                "--edit_concepts", "doctor; nurse", "--debias_concepts", "nfu; nxy",
                "--num_images_per_prompt", "2", "--num_inference_steps", "2",
                "--max_iterations", "1", "--image_size", "32", "--save_dir", str(tmp_path),
                "--exp_name", f"deb_{spec}", "--device_resident", "false", "--device", "cpu"]
        assert cli_main(argv + (["--mesh", spec] if spec else [])) == 0
        saved[spec] = read_safetensors(str(tmp_path / f"deb_{spec}.safetensors"))
    got, want = saved[f"data={n_data},model={n_model}"], saved[None]
    assert got.keys() == want.keys() and len(got) == len(w)
    assert all(k.endswith(("attn2.to_k.weight", "attn2.to_v.weight")) for k in got)
    for k in got:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), **SOLVE_TOL)
