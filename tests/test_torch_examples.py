"""The port's three examples (``repro_torch.examples``) on the CPU
(``--device cpu``), with the reference examples' lines:

* quickstart: reduced gemma2 trains 100 steps, its loss falls, it
  checkpoints and a second ``Trainer`` resumes from step 100;
* serve_batched: reduced rwkv6 serves 8 ragged requests through 4 slots
  (10 tokens each), the prefill/decode consistency check, 4 sampled
  continuations;
* tune_and_compare: the Fig. 18 table, a row per arch.
"""

import re

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import ARCH_IDS  # noqa: E402
from repro_torch.examples import quickstart  # noqa: E402
from repro_torch.examples import serve_batched  # noqa: E402
from repro_torch.examples import tune_and_compare  # noqa: E402


@pytest.fixture(autouse=True)
def one_thread():
    """The examples' tiny ops: one intra-op thread, so test workers that
    share the machine do not contend (~1.5 s against ~20 s for the
    quickstart with every core's thread)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(before)


def test_quickstart_trains_checkpoints_and_resumes(capsys):
    assert quickstart.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "--- loss curve ---" in out
    first, last = (float(x) for x in re.search(
        r"loss fell (\d+\.\d+) -> (\d+\.\d+);", out).groups())
    assert last < first
    assert "restored at step 100; continuing to 110" in out
    assert out.rstrip().endswith("resume OK")


def test_serve_batched_serves_and_checks(capsys):
    assert serve_batched.main(["--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    reqs = [ln for ln in lines if ln.startswith("req ")]
    assert len(reqs) == 8
    assert re.match(r"^8 requests / 80 tokens in ", lines[8])
    assert "prefill/decode consistency check passed" in lines
    assert re.match(r"^sampled \d distinct continuations from 4 identical "
                    r"prompts", lines[-1])


def test_tune_and_compare_prints_the_table(capsys):
    assert tune_and_compare.main([]) == 0
    lines = capsys.readouterr().out.splitlines()
    rows = {ln.split()[0]: ln for ln in lines[1:len(ARCH_IDS) + 1]}
    assert sorted(rows) == sorted(ARCH_IDS)
    for ln in rows.values():
        assert float(ln.split()[-1]) >= 0.99      # guideline / optimum
    assert lines[-1].startswith("gap = guideline / swept-optimum")
