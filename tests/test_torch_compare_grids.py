"""eval-compare on the port against uce_tpu's matplotlib grids: the same
files and count (case discovery, the case window, a case with a missing
image skipped), and each panel of the port's grid equal to its source
image (the layout differs from matplotlib's figure by design)."""

import os

import numpy as np
import pytest

from tests.torch_threads import one_torch_thread  # noqa: F401
from uce_tpu.eval import compare_grids as jgrids
from uce_tpu_torch.eval import compare_grids
from uce_tpu_torch.utils.imaging import load_image, save_png

SIZE = 24


@pytest.fixture
def folders(tmp_path):
    rng = np.random.default_rng(0)
    out = []
    for f in ("esd", "uce", "sd"):
        for case in (1, 3, 4, 7, 12):
            for num in (0, 1):
                if (f, case, num) == ("uce", 4, 1):
                    continue  # case 4 is incomplete: skipped
                save_png(rng.integers(0, 256, (SIZE, SIZE, 3), np.uint8),
                         str(tmp_path / f / f"{case}_{num}.png"))
        (tmp_path / f / "notes.txt").write_text("not a case")
        out.append(str(tmp_path / f))
    return out


@pytest.mark.parametrize("num_samples,window", [(2, (0, 1_000_000)), (1, (3, 7))])
def test_grids_match_uce_tpu(folders, tmp_path, num_samples, window):
    kw = dict(num_samples=num_samples, from_case=window[0], till_case=window[1])
    want_dir, got_dir = tmp_path / "ref", tmp_path / "port"
    want = jgrids.make_grids(folders, None, str(want_dir), **kw)
    got = compare_grids.make_grids(folders, None, str(got_dir), **kw)
    assert got == want and sorted(os.listdir(got_dir)) == sorted(os.listdir(want_dir))
    for name in os.listdir(got_dir):
        case = name.split(".")[0]
        grid = load_image(str(got_dir / name))
        assert grid.shape == (num_samples * SIZE, len(folders) * SIZE, 3)
        for row in range(num_samples):
            for col, folder in enumerate(folders):
                panel = grid[row * SIZE:(row + 1) * SIZE, col * SIZE:(col + 1) * SIZE]
                np.testing.assert_array_equal(
                    panel, load_image(os.path.join(folder, f"{case}_{row}.png")))


def test_tile_pads_a_smaller_panel():
    a = np.zeros((4, 6, 3), np.uint8)
    b = np.full((2, 3, 3), 7, np.uint8)
    grid = compare_grids.tile([[a, b]])
    assert grid.shape == (4, 12, 3)
    assert (grid[:2, 6:9] == 7).all() and (grid[2:, 6:] == 255).all()


def test_cli_prints_labels_in_column_order(folders, tmp_path, capsys):
    from uce_tpu_torch.cli.main import main as cli_main

    rc = cli_main(["eval-compare", "--folders", *folders, "--labels", "ESD", "UCE", "SD",
                   "--save_path", str(tmp_path / "grids"), "--till_case", "3"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "columns: ESD, UCE, SD" in out and "wrote 2 comparison grids" in out
