"""The port's CLI answers every uce command line: each subcommand of
uce_tpu's parser exists in the port's, with each of its flags, but for the
documented differences below. Flags that exist on both sides but mean
another thing: ``--device`` (uce pins the JAX platform; the port picks a
torch device, ``cuda`` by default, and never falls back to the CPU) and
``--jax_weights`` of eval-nudenet and eval-dreamsim (an alias of the port's
``--weights``)."""

import argparse

import pytest
import torch

from tests.torch_threads import one_torch_thread  # noqa: F401
from uce_tpu.cli.main import build_parser as uce_parser
from uce_tpu_torch.cli.main import build_parser as port_parser

# (subcommand, flag) of uce that the port does not take, each for a reason
# written in ROADMAP.md §3 (known divergences): none.
NOT_TAKEN = set()


def _subcommands(parser: argparse.ArgumentParser) -> dict[str, argparse.ArgumentParser]:
    (sub,) = [a for a in parser._actions if isinstance(a, argparse._SubParsersAction)]
    return dict(sub.choices)


def _flags(parser: argparse.ArgumentParser) -> set[str]:
    return {o for a in parser._actions for o in a.option_strings} - {"-h", "--help"}


UCE = _subcommands(uce_parser())
PORT = _subcommands(port_parser())


def test_every_uce_subcommand_has_a_port_counterpart():
    assert sorted(set(UCE) - set(PORT)) == []


@pytest.mark.parametrize("command", sorted(UCE))
def test_every_uce_flag_is_taken(command):
    missing = sorted(f for f in _flags(UCE[command]) - _flags(PORT[command])
                     if (command, f) not in NOT_TAKEN)
    assert missing == [], f"{command}: the port lacks {missing}"


def test_not_taken_list_is_current():
    """Each documented difference is still one (the list cannot go stale)."""
    for command, flag in NOT_TAKEN:
        assert flag in _flags(UCE[command]) and flag not in _flags(PORT[command])


@pytest.mark.parametrize("command", sorted(UCE))
def test_only_mesh_options_are_not_ported(command):
    """Every flag the port takes runs: no help text says "not ported" (the
    --mesh of debias-sd, generate, generate-flux, generate-hidream and
    serve, --quantize and --staged of the DiT commands and serve's families
    all run)."""
    for action in PORT[command]._actions:
        assert "not ported" not in (action.help or ""), (command, action.option_strings)
    choices = {a.dest: a.choices for a in PORT[command]._actions}
    if command == "serve":
        assert choices["family"] == ["sd", "flux", "hidream"]
        assert "ported" not in PORT[command]._option_string_actions["--family"].help


def test_dit_commands_take_quantize_and_staged():
    parser = port_parser()
    for command in ("generate-flux", "generate-hidream"):
        args = parser.parse_args([command, "--model_name", "m", "--prompts_path", "p",
                                  "--save_path", "s", "--quantize", "int8", "--staged",
                                  "--mesh", "model=2"])
        assert args.quantize == "int8" and args.staged and args.mesh == "model=2"
    args = parser.parse_args(["generate", "--model_id", "m", "--prompts_path", "p",
                              "--data_parallel", "--mesh", "data=2"])
    assert args.data_parallel and args.mesh == "data=2"


@pytest.mark.parametrize("command", ["eval-nudenet", "eval-dreamsim"])
def test_jax_weights_is_an_alias_of_weights(command):
    parser = port_parser()
    req = (["--image_folder", "d"] if command == "eval-nudenet"
           else ["--original_path", "a", "--edited_path", "b"])
    args = parser.parse_args([command, *req, "--jax_weights", "w.safetensors"])
    assert args.weights == "w.safetensors"
    assert parser.parse_args([command, *req]).device == "cuda"


def test_info_reports_without_a_card(tmp_path, monkeypatch, capsys):
    """``info`` exits 0 where torch finds no card, names each csrc/*.cu
    library and finds one built for the current sources without building."""
    from uce_tpu_torch.cli.main import main as cli_main
    from uce_tpu_torch.ops.kernels import _build

    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    built = _build.library_path("group_norm", ("group_norm.cu",))
    built.parent.mkdir(parents=True)
    built.write_bytes(b"")
    assert cli_main(["info"]) == 0
    out = capsys.readouterr().out
    assert f"torch {torch.__version__}" in out
    assert "CUDA available: no" in out
    libs = sorted(p.stem for p in _build.CSRC.glob("*.cu"))
    assert len(libs) == 7  # six ported kernels and FLUX's q/k norm + RoPE
    for name in libs:
        state = f"built {built}" if name == "group_norm" else "not built"
        assert f"  {name}: {state}" in out
    assert "eval-nudenet --weights" in out and "eval-dreamsim --weights" in out
    assert [p.name for p in tmp_path.rglob("*")] == [built.parent.name, built.name]
