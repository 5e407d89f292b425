"""PyTorch port: fig14's serve workloads
(``repro_torch.benchmarks.fig14_dispatch_overhead``) on the CPU, one
trial each at small request counts.

* Each workload's own asserts hold (sync-free chunk and exactly
  ``1 / sync_interval`` host syncs per step, clean teardown), and the
  token parity it records holds: the paged engines against each other
  and the dense ``ReferenceEngine``.
* ``fault_tolerance_comparison``: an oversubscribed pool preempts and
  resumes with the uncontended run's tokens, the expired request is
  reaped, nothing leaks; the traced twin of ``serve_engine_comparison``
  is sync-free and its export validates with complete chains.
* fig04's ``slo_scheduling_comparison`` and ``trace_report`` (the port's
  ``benchmarks/fig04_scheduling.py``): token parity across the policies,
  a deterministic trace and fingerprint, a valid export, zero leaks;
  its ``main`` merges the record into the last run of the file, and a
  plain run (the MoE and cost halves) ignores ``--out`` and writes
  nothing, as the reference's does.
* The record's keys, fig14's (``quantized_pool_comparison``'s ``qp_*``
  among them; its gates are in ``tests/test_torch_fig14_qp.py``) and
  fig04's together, equal the JAX record's (the last run of
  ``BENCH_serve.json``), less what the module docstring names as left
  out: the HLO checks.
* The dispatch trio, and so ``main``, raise without CUDA, naming the
  device, and write no record.
"""

import json
import pathlib

import pytest

torch = pytest.importorskip("torch")

from repro_torch.benchmarks import fig04_scheduling as fig04  # noqa: E402
from repro_torch.benchmarks import fig14_dispatch_overhead as fig14  # noqa: E402,E501


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs: the reduced models'
    ops are tiny, so one thread runs them as fast, and test processes
    that share the cores do not spin against each other's threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ROOT = pathlib.Path(__file__).resolve().parent.parent
HLO_KEYS = {"paged_kernel_gather_free", "gather_path_materializes_ring",
            "paged_kernel_peak_temp_bytes", "paged_gather_peak_temp_bytes",
            "cp_fused_gather_free"}


@pytest.fixture(scope="module")
def records():
    kw = dict(device="cpu", trials=1)
    return {
        "serve": fig14.serve_engine_comparison(n_req=6, max_new=8, **kw),
        "prefix": fig14.shared_prefix_comparison(n_req=6, max_new=8, **kw),
        "paged": fig14.paged_kernel_comparison(n_req=6, max_new=8, **kw),
        "spec": fig14.speculative_comparison(max_new=16, **kw),
        "cp": fig14.chunked_prefill_comparison(n_arrivals=2, prompt_len=40,
                                               **kw),
        "ft": fig14.fault_tolerance_comparison(device="cpu"),
        "slo": fig04.slo_scheduling_comparison(device="cpu"),
        "trep": fig04.trace_report(device="cpu"),
        "qp": fig14.quantized_pool_comparison(device="cpu"),
    }


def test_serve_engine_comparison(records):
    rec = records["serve"]
    assert rec["decode_sync_free"] is True
    assert rec["new_host_syncs_per_step"] == 1.0 / rec["sync_interval"]
    assert rec["ref_host_syncs_per_step"] >= 1.0
    # 6 ragged prompts of 2..12 tokens: 6 distinct lengths for the
    # reference, buckets 8 and 16 (+ the warmup's 32, 64) for the engine
    assert rec["ref_prefill_compiles"] == 6
    assert rec["new_prefill_compiles"] == len(rec["buckets"]) == 4
    assert rec["new_decode_compiles"] == rec["new_admit_compiles"] == 1
    assert rec["ref_tokens_per_s"] > 0 and rec["new_tokens_per_s"] > 0
    assert rec["peak_live_slots"] == 4


@pytest.mark.parametrize("name,match_key,sync_key", [
    ("prefix", "prefix_outputs_match_exclusive", "prefix_decode_sync_free"),
    ("paged", "paged_kernel_outputs_match", "paged_kernel_decode_sync_free"),
    ("spec", "spec_outputs_match", "spec_decode_sync_free"),
    ("cp", "cp_outputs_match", "cp_fused_decode_sync_free"),
])
def test_workload_parity_and_sync_freedom(records, name, match_key,
                                          sync_key):
    rec = records[name]
    assert rec[match_key] is True
    assert rec[sync_key] is True


def test_workload_telemetry(records):
    prefix, paged, spec, cp = (records[k] for k in ("prefix", "paged",
                                                    "spec", "cp"))
    assert prefix["prefix_hit_rate"] > 0 and prefix["prefix_pages_saved"] > 0
    assert paged["paged_kernel_backend"] == "torch-plain"
    assert paged["paged_kernel_table_blocks"] == 32
    assert spec["spec_steps"] > 0 and spec["spec_decode_compiles"] == 1
    assert cp["cp_fused_prefill_compiles"] == 0
    assert cp["cp_fused_decode_compiles"] == cp["cp_fused_admit_compiles"] \
        == 1
    for key in ("cp_fused_ttft_p50_s", "cp_fused_ttft_p99_s",
                "cp_legacy_ttft_p50_s", "cp_legacy_ttft_p99_s"):
        assert cp[key] > 0


def test_fault_tolerance_and_traced_twin(records):
    ft, serve = records["ft"], records["serve"]
    assert ft["ft_outputs_match"] is True
    assert ft["ft_preemptions"] >= 1 and ft["ft_resumes"] >= 1
    assert ft["ft_timed_out"] == 1 and ft["ft_leaked_pages"] == 0
    assert ft["ft_goodput"] == 8 / 9
    assert ft["ft_decode_sync_free"] is True
    assert ft["ft_decode_compiles"] == 1
    assert serve["trace_schema_valid"] is True
    assert serve["trace_complete_chains"] is True
    assert serve["trace_decode_sync_free"] is True
    assert serve["trace_dropped"] == 0 and serve["trace_events"] > 0


def test_fig04_slo_mix_and_trace_report(records, tmp_path):
    slo, trep = records["slo"], records["trep"]
    assert slo["slo_outputs_match"] is True
    assert slo["slo_trace_deterministic"] is True
    assert slo["slo_leaked_pages"] == slo["slo_fifo_leaked_pages"] == 0
    assert slo["slo_decode_sync_free"] is True
    assert slo["slo_decode_compiles"] == 1
    assert slo["slo_interactive_ttft_p99"] \
        <= slo["slo_fifo_interactive_ttft_p99"]
    assert trep["trep_schema_valid"] is True
    assert trep["trep_fingerprint_deterministic"] is True
    assert trep["trep_dropped"] == 0 and trep["trep_preemptions"] >= 1
    assert trep["trep_explain_ok"] is True
    out = tmp_path / "bench.json"
    out.write_text(json.dumps({"runs": [{"ts": 1.0, "speedup": 2.0}]}))
    rec = fig04.main(["--slo-mix", "--device", "cpu", "--out", str(out)])
    runs = json.loads(out.read_text())["runs"]
    assert len(runs) == 1 and runs[0]["speedup"] == 2.0
    assert runs[0]["slo_outputs_match"] == rec["slo_outputs_match"]
    # a plain run (the MoE and cost halves) ignores --out: it runs the
    # figure and writes nothing, as the reference's plain run does
    before = out.read_text()
    plain = fig04.main(["--device", "cpu", "--out", str(out)])
    assert sorted(plain) == ["moe_layer", "prod"]
    assert out.read_text() == before


def test_record_keys_match_reference_record(records):
    runs = json.loads((ROOT / "BENCH_serve.json").read_text())["runs"]
    want = {k for k in runs[-1] if k != "ts"} - HLO_KEYS
    got = set()
    for rec in records.values():
        assert not got & set(rec), got & set(rec)
        got |= set(rec)
    assert got == want


def test_trio_and_main_need_cuda(tmp_path):
    with pytest.raises(RuntimeError, match="device cpu is not a CUDA"):
        fig14.dispatch_trio("cpu")
    out = tmp_path / "bench.json"
    with pytest.raises(RuntimeError, match="not a CUDA device"):
        fig14.main(["--device", "cpu", "--out", str(out)])
    assert not out.exists()
