"""PyTorch port: fig14's serve workloads
(``repro_torch.benchmarks.fig14_dispatch_overhead``) on the CPU, one
trial each at small request counts.

* Each workload's own asserts hold (sync-free chunk and exactly
  ``1 / sync_interval`` host syncs per step, clean teardown), and the
  token parity it records holds: the paged engines against each other
  and the dense ``ReferenceEngine``.
* The record's keys equal the JAX record's (the last run of
  ``BENCH_serve.json``), less what the module docstring names as left
  out: the A11 and A15 workloads (``trace_*``, ``ft_*``, ``qp_*``), the
  HLO checks, and fig04's keys merged into the same run (``slo_*``,
  ``trep_*``).
* The dispatch trio, and so ``main``, raise without CUDA, naming the
  device, and write no record.
"""

import json
import pathlib

import pytest

torch = pytest.importorskip("torch")

from repro_torch.benchmarks import fig14_dispatch_overhead as fig14  # noqa: E402,E501

ROOT = pathlib.Path(__file__).resolve().parent.parent
HLO_KEYS = {"paged_kernel_gather_free", "gather_path_materializes_ring",
            "paged_kernel_peak_temp_bytes", "paged_gather_peak_temp_bytes",
            "cp_fused_gather_free"}
LEFT_OUT_PREFIXES = ("trace_", "ft_", "qp_", "slo_", "trep_")


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


def test_record_keys_match_reference_record(records):
    runs = json.loads((ROOT / "BENCH_serve.json").read_text())["runs"]
    want = {k for k in runs[-1] if k != "ts"
            and not k.startswith(LEFT_OUT_PREFIXES)} - HLO_KEYS
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
