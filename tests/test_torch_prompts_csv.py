"""The port's prompts-CSV reader against uce_tpu's pandas reading
(uce_tpu/eval/generate.py: ``pd.read_csv``, then ``str(r.prompt)``,
``int(r.evaluation_seed)`` and ``r.case_number`` for each row): the same
(case, prompt, seed) rows, an NA prompt included as the text "nan"."""

import glob
import os

import pandas as pd
import pytest

from tests.torch_threads import one_torch_thread  # noqa: F401
from uce_tpu.utils.imaging import case_window
from uce_tpu_torch.eval.generate import PANDAS_NA_STRINGS, read_prompts_csv

DATA = os.path.join(os.path.dirname(__file__), os.pardir, "data")
COLUMNS = {"case_number", "prompt", "evaluation_seed"}
PROMPT_CSVS = sorted(
    os.path.basename(p) for p in glob.glob(os.path.join(DATA, "*.csv"))
    if COLUMNS <= set(pd.read_csv(p, nrows=0).columns))


def _uce_tpu_rows(path):
    rows = case_window(pd.read_csv(path), 0, 10 ** 12)
    return [(int(r.case_number), str(r.prompt), int(r.evaluation_seed)) for r in rows]


def _port_rows(path):
    return [(r["case_number"], r["prompt"], r["evaluation_seed"])
            for r in read_prompts_csv(path)]


def test_every_prompts_csv_is_found():
    assert len(PROMPT_CSVS) >= 27 and "unsafe-prompts4703.csv" in PROMPT_CSVS


@pytest.mark.parametrize("name", PROMPT_CSVS)
def test_rows_match_uce_tpu(name):
    path = os.path.join(DATA, name)
    assert _port_rows(path) == _uce_tpu_rows(path)


def test_unsafe_case_2260_reads_nan():
    """Its prompt field is empty: uce_tpu feeds its pipeline "nan"."""
    rows = {c: p for c, p, _ in _port_rows(os.path.join(DATA, "unsafe-prompts4703.csv"))}
    assert rows[2260] == "nan"


def test_synthetic_na_prompts(tmp_path):
    """Empty, quoted-empty and NA-looking prompts, and prompts that only
    contain such a word, next to one that pandas keeps."""
    path = tmp_path / "prompts.csv"
    path.write_text(
        "case_number,prompt,evaluation_seed\n"
        "0,,1\n"
        '1,"",2\n'
        "2,NA,3\n"
        "3,None,4\n"
        "4,nan,5\n"
        "5,#N/A,6\n"
        "6,null,7\n"
        "7,a photo of None,8\n"
        "8, NA,9\n"
        "9,\"a dog, NA\",10\n", encoding="utf-8")
    got = _port_rows(str(path))
    assert got == _uce_tpu_rows(str(path))
    assert [p for _, p, _ in got[:7]] == ["nan"] * 7
    assert got[7][1] == "a photo of None" and got[9][1] == "a dog, NA"


def test_na_strings_are_pandas_defaults():
    from pandas._libs.parsers import STR_NA_VALUES

    assert PANDAS_NA_STRINGS == frozenset(STR_NA_VALUES)
