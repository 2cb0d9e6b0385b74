"""uce_tpu_torch must run where jax, uce_tpu, safetensors, transformers,
pandas, PIL and regex are absent (the CUDA machine has none of them): every
module imports and the CLI answers --help with all of them blocked."""

import subprocess
import sys

BLOCKED = ("jax", "jaxlib", "uce_tpu", "safetensors", "transformers", "pandas",
           "PIL", "regex")

SCRIPT = f"""
import importlib, importlib.abc, pkgutil, sys

BLOCKED = {BLOCKED!r}

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError("blocked: " + name)
        return None

for name in list(sys.modules):
    if name.split(".")[0] in BLOCKED:
        del sys.modules[name]
sys.meta_path.insert(0, Block())

import uce_tpu_torch
names = [m.name for m in pkgutil.walk_packages(uce_tpu_torch.__path__, "uce_tpu_torch.")
         if m.name != "uce_tpu_torch.__main__"]
FLUX = {{"uce_tpu_torch.models.t5", "uce_tpu_torch.models.flux",
         "uce_tpu_torch.diffusion.pipeline_flux", "uce_tpu_torch.edit.flux",
         "uce_tpu_torch.cli.edit_cmds", "uce_tpu_torch.cli.flux_gen_cmd"}}
assert FLUX <= set(names), FLUX - set(names)
HIDREAM = {{"uce_tpu_torch.models.llama", "uce_tpu_torch.models.hidream",
            "uce_tpu_torch.diffusion.pipeline_hidream", "uce_tpu_torch.edit.hidream",
            "uce_tpu_torch.cli.hidream_gen_cmd"}}
assert HIDREAM <= set(names), HIDREAM - set(names)
EVAL = {{"uce_tpu_torch.diffusion.guidance", "uce_tpu_torch.eval.baselines",
         "uce_tpu_torch.models.vision_backbones", "uce_tpu_torch.eval.lpips",
         "uce_tpu_torch.eval.styleloss", "uce_tpu_torch.eval.imageclassify",
         "uce_tpu_torch.eval.clip_score", "uce_tpu_torch.eval.table"}}
assert EVAL <= set(names), EVAL - set(names)
for name in names:
    importlib.import_module(name)
from uce_tpu_torch.cli.main import main
for argv in (["--help"], ["edit-sd", "--help"], ["edit-sdxl", "--help"],
             ["edit-flux", "--help"], ["generate", "--help"], ["generate-flux", "--help"],
             ["edit-hidream", "--help"], ["generate-hidream", "--help"],
             ["serve", "--help"], ["debias-sd", "--help"],
             ["eval-clip-classify", "--help"], ["sld-generate", "--help"],
             ["concept-algebra", "--help"], ["debias-vl", "--help"],
             ["eval-lpips", "--help"], ["eval-styleloss", "--help"],
             ["eval-imageclassify", "--help"], ["eval-clip-score", "--help"]):
    try:
        main(argv)
    except SystemExit as e:
        assert e.code == 0, (argv, e.code)
leaked = sorted(n for n in sys.modules if n.split(".")[0] in BLOCKED)
assert not leaked, leaked
print("imported", len(names))
"""


def test_port_imports_without_reference_packages():
    proc = subprocess.run([sys.executable, "-c", SCRIPT], capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert int(proc.stdout.split("imported")[-1]) >= 64


def test_module_entry_point_help():
    proc = subprocess.run([sys.executable, "-m", "uce_tpu_torch", "--help"],
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0 and "edit-sd" in proc.stdout
    assert "edit-flux" in proc.stdout and "generate-flux" in proc.stdout
    assert "edit-hidream" in proc.stdout and "generate-hidream" in proc.stdout
    for command in ("sld-generate", "concept-algebra", "debias-vl", "eval-lpips",
                    "eval-styleloss", "eval-imageclassify", "eval-clip-score"):
        assert command in proc.stdout, command
