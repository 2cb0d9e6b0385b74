"""The FLOP count of one image against the analytic counts of the port's
``tools/flop_count.py`` for SD 1.4."""

import pytest

from perfbench.core import harness, work
from perfbench.reference import generate as ref


def _by_label(items):
    return {label: work.flops_per_image([(label, fn, 1)]) for label, fn, _ in items}


def _cell(name):
    config, traffic = {"sd14-eval-b8": ("sd14", "eval-artists-b8")}[name]
    return (harness.read_json(harness.BENCH / "configs" / f"{config}.json"),
            harness.read_json(harness.BENCH / "traffic" / f"{traffic}.json"))


def test_sd14_flops():
    cfg, traffic = _cell("sd14-eval-b8")
    items = ref.sd_work(cfg, traffic)
    one = _by_label(items)
    assert one["unet"] / 1e9 == pytest.approx(803.3, abs=0.05)  # UNet, 64x64 latent
    assert one["vae"] / 1e9 == pytest.approx(2514.5, abs=0.05)  # decode to 512x512
    assert {label: times for label, _, times in items} == {"unet": 102, "vae": 1, "clip": 2}
    assert work.flops_per_image(items) / 1e12 == pytest.approx(84.5, abs=0.05)


def test_attention_calls_of_an_sd14_image():
    cfg, traffic = _cell("sd14-eval-b8")
    calls = work.attention_calls(ref.sd_work(cfg, traffic))
    long_self = [(s, n) for s, n in calls if s[2] == s[3] and s[2] >= 1024]
    assert sorted(set(long_self)) == [((1, 1, 4096, 4096, 512), 1),
                                      ((1, 8, 1024, 1024, 80), 102),
                                      ((1, 8, 4096, 4096, 40), 102)]
    assert sum(1 for s, _ in long_self if s[4] in (40, 80)) == 10
