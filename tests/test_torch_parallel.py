"""The port's multi-device execution (uce_tpu_torch/parallel/{mesh,workers}.py
and ``SDPipeline.apply_mesh``) against uce_tpu's (uce_tpu/parallel/mesh.py on
tests/conftest.py's 8 virtual CPU devices) and against the port's own
single-rank runs.

The port's ranks are spawned processes on gloo, one torch thread each, each
group meeting through a file store under the test's tmp_path. Tolerances:
data parallelism gives the single-rank images bit for bit (each rank runs
its rows through the same code; held exactly) and uce_tpu's within 1 uint8
level (the bar of tests/test_pipeline_parity.py); a tensor-parallel UNet
forward holds the single-rank one at rtol = atol = 2e-5 (fp32, only the
order of the row-parallel sums differs) and uce_tpu's sharded forward at
tests/test_torch_unet_vae.py's 2e-4; whole tensor-parallel generations stay
within 1 uint8 level of single-rank (uce_tpu's own TP bar); W8A8 under
row parallelism quantizes with the whole width's scale, so its int8
payloads, scales and outputs equal the unsharded ones bit for bit."""

import numpy as np
import pytest
import torch
import torch.distributed as dist

from tests.torch_dist_helpers import param_bytes
from tests.torch_threads import one_torch_thread  # noqa: F401
from uce_tpu_torch.diffusion import pipeline as tpipeline
from uce_tpu_torch.diffusion.sampler import FastConfig
from uce_tpu_torch.models import quantize as tquantize, unet as tunet
from uce_tpu_torch.models.convert import nested_to_state_dict
from uce_tpu_torch.ops import quant
from uce_tpu_torch.parallel import mesh as tmesh, workers

CPU = torch.device("cpu")
GEN = dict(num_inference_steps=2, height=32, width=32)
# three heads at the first level: model=2 splits them 2 + 1
TINY_UNET = dict(block_out_channels=(12, 24),
                 down_block_types=("CrossAttnDownBlock2D", "DownBlock2D"),
                 up_block_types=("UpBlock2D", "CrossAttnUpBlock2D"),
                 layers_per_block=1, cross_attention_dim=16, attention_head_dim=3,
                 norm_num_groups=4)


def _max_diff(a, b) -> int:
    return int(np.abs(np.asarray(a).astype(np.int32) - np.asarray(b).astype(np.int32)).max())


def _mesh(tmp_path, n_data, n_model):
    return tmesh.make_mesh(n_data, n_model, devices="cpu", store_dir=str(tmp_path))


# ---------------------------------------------------------------- the mesh

@pytest.mark.parametrize("spec,n", [("data=2", 2), ("model=2", 8), ("data=0,model=2", 8),
                                    ("data=2,model=4", 8)])
def test_mesh_from_spec_matches_uce_tpu(spec, n):
    import jax

    from uce_tpu.parallel import mesh as jmesh

    want = dict(jmesh.mesh_from_spec(spec, devices=jax.devices()[:n]).shape)
    got = tmesh.mesh_from_spec(spec, devices=[CPU] * n)
    assert got.shape == want
    assert got.devices == (CPU,) * n and got.backend == "gloo"
    # rank d * n_model + m holds data slice d and model shard m
    assert [got.coords(r) for r in range(n)] == [
        divmod(r, want["model"]) for r in range(n)]


@pytest.mark.parametrize("spec", ["model=0", "data=-1", "chips=8", "data=3,model=2"])
def test_mesh_from_spec_rejects_what_uce_tpu_rejects(spec):
    import jax

    from uce_tpu.parallel import mesh as jmesh

    with pytest.raises(ValueError) as want:
        jmesh.mesh_from_spec(spec, devices=jax.devices())
    with pytest.raises(ValueError) as got:
        tmesh.mesh_from_spec(spec, devices=[CPU] * 8)
    assert str(got.value) == str(want.value)


def test_require_data_axis_and_backend_rule():
    import jax
    from jax.sharding import Mesh

    from uce_tpu.parallel import mesh as jmesh

    no_data = Mesh(np.array(jax.devices()), ("model",))
    with pytest.raises(ValueError, match="data"):
        jmesh.require_data_axis(no_data)
    with pytest.raises(ValueError, match="data"):
        tmesh.require_data_axis(no_data)
    tmesh.require_data_axis(tmesh.make_mesh(2, 1, devices="cpu"))
    jmesh.require_data_axis(jmesh.make_mesh(8, 1))
    # one CUDA device per rank: NCCL; ranks sharing a card or on the CPU: gloo
    cuda = [torch.device("cuda", i) for i in range(2)]
    assert tmesh.make_mesh(2, 1, devices=cuda).backend == "nccl"
    assert tmesh.make_mesh(1, 2, devices=["cuda:0", "cuda"]).backend == "gloo"
    assert tmesh.make_mesh(devices="cpu", n_model=2).shape == {"data": 1, "model": 2}
    with pytest.raises(ValueError, match="all CPU or all CUDA"):
        tmesh.make_mesh(2, 1, devices=["cpu", "cuda:0"])


def test_pad_batch_matches_uce_tpu():
    import jax.numpy as jnp

    from uce_tpu.parallel import mesh as jmesh

    x = np.arange(2 * 3 * 4, dtype=np.float32).reshape(6, 4)  # 2 branches of 3
    for n_data in (1, 2, 4):
        np.testing.assert_array_equal(
            tmesh.pad_batch(torch.from_numpy(x), n_data).numpy(),
            np.asarray(jmesh.pad_batch(jnp.asarray(x), n_data)))
        padded = tmesh.pad_batch_branched(torch.from_numpy(x), n_data, 2)
        np.testing.assert_array_equal(
            padded.numpy(), np.asarray(jmesh.pad_batch_branched(jnp.asarray(x), n_data, 2)))
        # each data group takes its rows of every branch; together, all of them
        shards = [tmesh.data_shard(padded, n_data, d, 2) for d in range(n_data)]
        for branch in range(2):
            rows = torch.cat([s.chunk(2)[branch] for s in shards])
            assert torch.equal(rows, padded.chunk(2)[branch])
    llama = np.arange(3 * 6 * 2, dtype=np.float32).reshape(3, 6, 2)
    np.testing.assert_array_equal(
        tmesh.pad_batch_branched(torch.from_numpy(llama), 4, 2, axis=1).numpy(),
        np.asarray(jmesh.pad_batch_branched(jnp.asarray(llama), 4, 2, axis=1)))


# ---------------------------------------------------------------- the UNet's layout

def _jax_sharded_keys(jparams, shard_fn) -> set:
    """The dotted paths of the leaves that uce_tpu's ``shard_fn`` shards
    over 'model' on a 4x2 mesh."""
    import jax

    from uce_tpu.parallel import mesh as jmesh

    placed = shard_fn(jparams, jmesh.make_mesh(n_data=4, n_model=2))
    out = set()
    for path, leaf in jax.tree_util.tree_flatten_with_path(placed)[0]:
        if any(axis is not None for axis in leaf.sharding.spec):
            out.add(".".join(str(p.key) for p in path))
    return out


def test_unet_layout_matches_uce_tpu_and_reassembles():
    """A key is sharded exactly where uce_tpu's spec_for shards its leaf;
    the ranks' slices (whole heads, 2 + 1 at the 3-head level; the GEGLU
    halves each split alike) put back together give every tensor bit for
    bit; a rank's bytes fall as the model axis grows."""
    from uce_tpu.models import unet as junet
    from uce_tpu.parallel import mesh as jmesh

    jcfg, tcfg = junet.UNetConfig(**TINY_UNET), tunet.UNetConfig(**TINY_UNET)
    jparams = junet.nest_state_dict(junet.init_state_dict(jcfg, np.random.default_rng(0)))
    params = nested_to_state_dict(jparams)
    want = _jax_sharded_keys(jparams, jmesh.shard_unet_params)
    layout = tmesh.layout_fn("unet", tcfg, 2)
    got = {k for k, v in params.items() if layout(k, v) is not None}
    assert got == want and any("to_out" in k for k in got)
    key = "down_blocks.0.attentions.0.transformer_blocks.0.attn1.to_q.weight"
    assert layout(key, params[key]).runs == (((0, 8),), ((8, 12),))  # heads 2 + 1 of dh 4
    ff = "down_blocks.0.attentions.0.transformer_blocks.0.ff.net.0.proj.weight"
    rank0 = tmesh.shard_unet_params(params, tmesh.make_mesh(1, 2, devices="cpu"), 0, tcfg)
    assert torch.equal(rank0[ff], torch.cat([params[ff][:24], params[ff][48:72]]))
    sizes = []
    for n_model in (1, 2, 3):
        mesh = tmesh.make_mesh(1, n_model, devices="cpu")
        parts = [tmesh.shard_unet_params(params, mesh, r, tcfg) for r in range(n_model)]
        lay = tmesh.layout_fn("unet", tcfg, n_model)
        for k, v in params.items():
            assert torch.equal(tmesh.unshard_value([p[k] for p in parts], lay(k, v)), v), k
        sizes.append(param_bytes(parts[0]))
    assert sizes[0] == param_bytes(params) and sizes[0] > sizes[1] > sizes[2]


# ---------------------------------------------------------------- SD pipelines

@pytest.fixture(scope="module")
def snap(tmp_path_factory):
    from tests.snapshot import make_sd_snapshot

    return str(make_sd_snapshot(tmp_path_factory.mktemp("torch_parallel_snap")))


@pytest.fixture(scope="module")
def tpipe(snap):
    return tpipeline.SDPipeline.from_pretrained(snap, dtype=torch.float32, device="cpu")


def test_data_parallel_generation_matches_single_and_uce_tpu(snap, tpipe, tmp_path):
    """data=2 over 3 prompts (one padding row) and over 4: the single-rank
    images bit for bit, uce_tpu's data=2 images within 1 uint8 level; the
    images served from the meshed pipeline equal the direct ones; no rank
    imports jax."""
    import jax
    import jax.numpy as jnp

    from tests.torch_dist_helpers import imports_jax
    from uce_tpu.diffusion.pipeline import SDPipeline as JaxSD
    from uce_tpu.parallel import mesh as jmesh
    from uce_tpu_torch.serving.server import GenerationServer, ServerConfig

    jpipe = JaxSD.from_pretrained(snap, dtype=jnp.float32)
    jpipe.apply_mesh(jmesh.make_mesh(2, 1, devices=jax.devices()[:2]))
    cases = [(["a cat", "a dog", "a fox"], [1, 2, 3]), (["a", "b", "c", "d"], [4, 5, 6, 7])]
    base = [tpipe(p, seed=s, **GEN) for p, s in cases]
    direct = tpipe(["a cat"], seed=[7], negative_prompt=[""], **GEN)
    tpipe.apply_mesh(_mesh(tmp_path, 2, 1))
    try:
        assert workers.run(imports_jax, None, {}, {}) == [True, False]
        for (prompts, seeds), want in zip(cases, base):
            got = tpipe(prompts, seed=seeds, **GEN)
            assert got.shape == want.shape == (len(prompts), 32, 32, 3)
            np.testing.assert_array_equal(got, want)
            assert _max_diff(got, jpipe(prompts, seed=seeds, **GEN)) <= 1
        cfg = ServerConfig(batch_size=2, max_wait_ms=1, **GEN, guidance_scale=7.5)
        with GenerationServer(tpipe, cfg) as srv:
            np.testing.assert_array_equal(srv.generate("a cat", seed=7), direct[0])
    finally:
        tpipe.apply_mesh(None)


def test_tensor_parallel_unet_matches_single_and_uce_tpu(tmp_path):
    """A UNet forward at model=2 with a 3-head level (split 2 + 1) against
    the single-rank forward and uce_tpu's shard_unet_params forward; with
    the UNet in W8A8 (trap 2: each row-parallel layer reduces its per-token
    absmax, then its int32 products), the activation's int8 payload and
    scale on every rank and the output equal the unsharded ones bit for bit,
    and the whole quantized forward meets test_torch_quant.py's bar."""
    import jax
    import jax.numpy as jnp

    from tests.torch_dist_helpers import row_qlinear
    from uce_tpu.models import unet as junet
    from uce_tpu.parallel import mesh as jmesh

    jcfg, tcfg = junet.UNetConfig(**TINY_UNET), tunet.UNetConfig(**TINY_UNET)
    jparams = junet.nest_state_dict(
        junet.init_state_dict(jcfg, np.random.default_rng(3), scale=0.1))
    params = nested_to_state_dict(jparams)
    qparams = tquantize.quantize_params(params, tquantize.UNET_SKIP, "int8")
    rng = np.random.default_rng(5)
    x = rng.standard_normal((4, 16, 16, 4)).astype(np.float32)
    ctx = rng.standard_normal((4, 7, 16)).astype(np.float32)
    t = np.array([123.0, 801.0, 5.0, 400.0], np.float32)
    sample = torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))
    batch = {"sample": (sample, None), "timesteps": (torch.from_numpy(t), None),
             "context": (torch.from_numpy(ctx), None)}
    spec = {"unet_config": tcfg}
    single = tpipeline.denoiser_forward({"unet": params}, spec,
                                        {k: v for k, (v, _) in batch.items()})
    qsingle = tpipeline.denoiser_forward({"unet": qparams}, spec,
                                         {k: v for k, (v, _) in batch.items()})

    jmesh_ = jmesh.make_mesh(n_data=4, n_model=2)
    with jmesh_:
        want = np.asarray(jax.jit(lambda p, x, t, c: junet.apply(p, x, t, c, jcfg))(
            jmesh.shard_unet_params(jparams, jmesh_), jmesh.shard_batch(jnp.asarray(x), jmesh_),
            jnp.asarray(t), jmesh.shard_batch(jnp.asarray(ctx), jmesh_)))

    xw = torch.from_numpy(rng.standard_normal((2, 5, 24)).astype(np.float32))
    qw = quant.quantize_weight(torch.from_numpy(
        rng.standard_normal((16, 24)).astype(np.float32)))
    bias = torch.from_numpy(rng.standard_normal(16).astype(np.float32))
    xq_full, xs_full = quant._quant_act(xw, (-1,))
    runs = [tmesh.split_range(24, r, 2) for r in range(2)]

    workers.start(_mesh(tmp_path, 1, 2))
    try:
        layout = tmesh.layout_fn("unet", tcfg, 2)
        local = workers.send_params("unet", params.items(), layout)
        got = workers.run(tpipeline.denoiser_forward, spec, batch, {"unet": local})
        assert got[1] is None  # model rank 1 returns nothing
        qlocal = workers.send_params("unet", qparams.items(), layout)
        qgot = workers.run(tpipeline.denoiser_forward, spec, batch, {"unet": qlocal})[0]
        probes = workers.run(row_qlinear, {"runs": runs},
                             {"x": (xw, None), "q": (qw[quant.QKEY], None),
                              "scale": (qw["scale"], None), "bias": (bias, None)}, {})
    finally:
        workers.stop()
    np.testing.assert_allclose(got[0].numpy(), single.numpy(), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got[0].numpy().transpose(0, 2, 3, 1), want,
                               rtol=2e-4, atol=2e-4)
    assert torch.equal(torch.cat([p[0] for p in probes], dim=-1), xq_full)
    for _, xs, y in probes:
        assert torch.equal(xs, xs_full)
        assert torch.equal(y, quant.qlinear(xw, qw, bias))
    rel = float((qgot - qsingle).norm() / qsingle.norm())
    assert rel <= 1e-3  # test_torch_quant.py's NET_REL_L2


def test_mesh_and_fast_compose_and_apply_mesh_none_reverts(tpipe, tmp_path):
    """data=2,model=2 (4 ranks) with the CFG window and DeepCache, the
    counterpart of uce_tpu's test_mesh_and_fast_compose: within 1 uint8
    level of single-rank and the same again on a second call. Then
    apply_mesh(None): the workers exit, rank 0 leaves its process group,
    the UNet is whole and equal to the one before the mesh, and the next
    call equals the single-rank images."""
    fc = FastConfig(cfg_interval=(1, 3), cache_interval=2)
    kw = dict(GEN, num_inference_steps=4, seed=[1, 2, 3, 4], guidance_scale=7.5, fast=fc)
    prompts = ["a", "b", "c", "d"]
    base = tpipe(prompts, **kw)
    before = dict(tpipe.unet_params)
    tpipe.apply_mesh(_mesh(tmp_path, 2, 2))
    procs = workers.session().procs
    try:
        key = "down_blocks.0.attentions.0.transformer_blocks.0.attn1.to_q.weight"
        assert tpipe.unet_params[key].shape[0] < before[key].shape[0]
        meshed = tpipe(prompts, **kw)
        again = tpipe(prompts, **kw)
    finally:
        tpipe.apply_mesh(None)
    assert meshed.shape == base.shape and _max_diff(meshed, base) <= 1
    np.testing.assert_array_equal(meshed, again)
    assert len(procs) == 3 and not any(p.is_alive() for p in procs)
    assert workers.session() is None and not dist.is_initialized()
    assert tpipe.unet_params.keys() == before.keys()
    for k, v in before.items():
        assert tpipe.unet_params[k].device == CPU and torch.equal(tpipe.unet_params[k], v), k
    np.testing.assert_array_equal(tpipe(prompts, **kw), base)


def test_a_failing_rank_ends_the_mesh(tmp_path):
    """A rank that raises leaves at once; the controller's collective fails,
    and it kills the workers and leaves the group instead of waiting."""
    from tests.torch_dist_helpers import fail_off_controller

    workers.start(_mesh(tmp_path, 1, 2))
    procs = workers.session().procs
    with pytest.raises(RuntimeError):
        workers.run(fail_off_controller, None, {}, {})
    assert workers.session() is None and not dist.is_initialized()
    assert not any(p.is_alive() for p in procs)


def test_generate_cli_mesh_and_data_parallel(snap, tmp_path):
    """``generate --mesh data=2`` (each data group writes its own PNGs) and
    ``--data_parallel`` (one visible CPU device: no mesh) write the files of
    the single-rank run, bit for bit."""
    from uce_tpu_torch.cli.main import main
    from uce_tpu_torch.utils.imaging import decode_png

    csv = tmp_path / "prompts.csv"
    csv.write_text("case_number,prompt,evaluation_seed\n0,a cat,7\n1,a dog,9\n2,a bird,11\n")
    common = ["generate", "--model_id", snap, "--prompts_path", str(csv), "--image_size", "32",
              "--num_inference_steps", "2", "--dtype", "float32", "--batch_rows", "3",
              "--num_samples", "2", "--exp_name", "run", "--device", "cpu"]
    runs = {"single": [], "mesh": ["--mesh", "data=2"], "dp": ["--data_parallel"]}
    for name, extra in runs.items():
        assert main(common + ["--save_path", str(tmp_path / name), *extra]) == 0
    for case in (0, 1, 2):
        for num in (0, 1):
            want = (tmp_path / "single" / "run" / f"{case}_{num}.png").read_bytes()
            for name in ("mesh", "dp"):
                got = (tmp_path / name / "run" / f"{case}_{num}.png").read_bytes()
                np.testing.assert_array_equal(decode_png(got), decode_png(want))
    assert workers.session() is None
