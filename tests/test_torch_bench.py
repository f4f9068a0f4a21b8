"""tpulab_torch's roofline accounting and the model rows of its ``bench``,
held against tpulab's on the CPU.

The flop counts are integers and must equal tpulab's exactly.  The rows
run here at small sizes, through ``run_benchmarks(only=...)`` with the
sizes their own signatures take; on the CPU a row carries no MFU fields
(there is no peak to divide by).  Metric names must equal tpulab's: the
f-string that names each row is compared with tpulab's source, and each
row run here is held to the name that f-string gives.
"""

import ast
import inspect
import textwrap

import numpy as np
import pytest
import torch

from tpulab import bench as jbench
from tpulab.models import labformer as jlf
from tpulab.obs import roofline as jroof

from tpulab_torch import bench
from tpulab_torch.models import labformer as tlf
from tpulab_torch.obs import roofline as troof

torch.set_num_threads(2)

H100 = "NVIDIA H100 80GB HBM3"


def _port_cfg(jcfg):
    return tlf.cfg_from_dict(jlf.cfg_to_dict(jcfg))


@pytest.mark.parametrize("kw", [
    dict(d_model=512, n_heads=8, n_layers=8, d_ff=2048),
    dict(d_model=512, n_heads=8, n_layers=8, d_ff=2048, n_kv_heads=2),
    dict(d_model=64, n_heads=4, n_layers=2, d_ff=128, n_experts=4, moe_top_k=2),
    dict(d_model=128, n_heads=8, n_layers=4, d_ff=512, vocab=1000),
], ids=["dense", "gqa", "moe", "vocab"])
@pytest.mark.parametrize("b,s,causal", [(8, 512, True), (1, 2048, False), (3, 7, True)])
def test_flop_counts_equal_tpulab(kw, b, s, causal):
    jcfg = jlf.LabformerConfig(**kw)
    cfg = _port_cfg(jcfg)
    got = troof.labformer_fwd_flops(cfg, b, s, causal)
    assert isinstance(got, int) and got == jroof.labformer_fwd_flops(jcfg, b, s, causal)
    assert troof.per_token_flops(cfg) == jroof.per_token_flops(jcfg)


def test_device_peaks_key_on_the_card_name():
    peaks = troof.device_peaks(device_kind=H100)
    assert peaks == {"device_kind": H100, "peak_tflops": 989.0, "peak_gbps": 3350.0}
    for name in ("NVIDIA H100 PCIe", "NVIDIA A100-SXM4-80GB", "cpu", ""):
        assert troof.device_peaks(device_kind=name)["peak_tflops"] is None
        assert troof.device_peaks(device_kind=name)["peak_gbps"] is None
    assert troof.device_peaks(torch.device("cpu")) == {
        "device_kind": "cpu", "peak_tflops": None, "peak_gbps": None}


def test_mfu_fields_math(monkeypatch):
    """494.5 TFLOP/s achieved on a 989 TFLOP/s card is 50 %; the same
    fields as tpulab's for the same peak."""
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *a: H100)
    card = torch.device("cuda", 0)
    f = troof.mfu_fields(494.5e9, 1.0, card)  # 494.5 GFLOP in 1 ms
    assert f == {"model_flops": 494.5e9, "achieved_tflops": 494.5,
                 "mfu_pct_of_bf16_peak": 50.0, "peak_tflops": 989.0}

    class Named:
        device_kind = "TPU v5 lite"

    want = jroof.mfu_fields(98.5e9, 1.0, Named())
    got = troof.mfu_fields(98.5e9, 1.0, card)
    assert set(got) == set(want)
    assert troof.mfu_pct(494.5e12, 1.0, troof.device_peaks(device_kind=H100)) == \
        pytest.approx(50.0)
    assert troof.mfu_pct(494.5e12, 1.0, {"peak_tflops": None}) == 0.0
    if not torch.cuda.is_available():  # the default peaks are the CPU's
        assert troof.mfu_pct(494.5e12, 1.0) == 0.0


def test_mfu_fields_empty_without_peak_or_flops(monkeypatch):
    assert troof.mfu_fields(1e9, 1.0, torch.device("cpu")) == {}
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *a: "NVIDIA L4")
    assert troof.mfu_fields(1e9, 1.0, torch.device("cuda", 0)) == {}
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *a: H100)
    assert troof.mfu_fields(0, 1.0, torch.device("cuda", 0)) == {}
    assert troof.mfu_fields(1e9, 0.0, torch.device("cuda", 0)) == {}


# ------------------------------------------------------------ metric names

#: port row -> tpulab row (the functions that name the metric)
ROW_FUNCS = {
    "labformer_fwd": ("bench_labformer", "bench_labformer"),
    "labformer_train": ("bench_labformer_train", "bench_labformer_train"),
    "labvision_train": ("bench_labvision_train", "bench_labvision_train"),
    "labformer_decode": ("bench_labformer_decode", "bench_labformer_decode"),
    "speculative_decode": ("bench_speculative_decode", "bench_speculative_decode"),
    "paged_engine": ("bench_paged_engine", "bench_paged_engine"),
    "paged_tick_overhead": ("bench_paged_tick", "bench_paged_tick"),
    "mesh_tick_overhead": ("bench_mesh_tick_overhead", "bench_mesh_tick_overhead"),
    "prefill_interleave": ("bench_prefill_interleave", "bench_prefill_interleave"),
    "obs_overhead": ("bench_obs_overhead", "bench_obs_overhead"),
    "journey_overhead": ("bench_journey_overhead", "bench_journey_overhead"),
    "fault_overhead": ("bench_fault_overhead", "bench_fault_overhead"),
    "obs_history_overhead": ("bench_obs_history_overhead", "bench_obs_history_overhead"),
    "journal_overhead": ("bench_journal_overhead", "bench_journal_overhead"),
    "autoscale_overhead": ("bench_autoscale_overhead", "bench_autoscale_overhead"),
    "spill_overhead": ("bench_spill_overhead", "bench_spill_overhead"),
    "handoff_overhead": ("bench_handoff_overhead", "bench_handoff_overhead"),
    "prefix_lookup": ("bench_prefix_lookup", "bench_prefix_lookup"),
    "train_step_overhead": ("bench_train_step", "bench_train_step"),
    "flash_attention": ("bench_flash_attention", "bench_flash_attention"),
}


def _metric_parts(fn):
    """The source of the ``metric`` f-string of ``fn``, and of the ``tag``
    it reads where it has one."""
    tree = ast.parse(textwrap.dedent(inspect.getsource(fn)))
    metric = tag = None
    for node in ast.walk(tree):
        if isinstance(node, ast.Dict):
            for key, value in zip(node.keys, node.values):
                if isinstance(key, ast.Constant) and key.value == "metric":
                    metric = ast.unparse(value)
        if isinstance(node, ast.Call) and getattr(node.func, "id", "") == "_model_row":
            metric = ast.unparse(node.args[0])
        if isinstance(node, ast.Assign) and getattr(node.targets[0], "id", "") == "tag":
            tag = ast.unparse(node.value)
    return metric, tag


@pytest.mark.parametrize("row", sorted(ROW_FUNCS))
def test_metric_names_are_tpulabs(row):
    """Each model row names its metric with tpulab's f-string, and takes
    tpulab's defaults; the registry carries tpulab's names and partials."""
    tname, jname = ROW_FUNCS[row]
    tfn, jfn = getattr(bench, tname), getattr(jbench, jname)
    assert _metric_parts(tfn) == _metric_parts(jfn)
    assert _metric_parts(tfn)[0] is not None
    tparams = {k: p.default for k, p in inspect.signature(tfn).parameters.items()
               if k != "backend"}
    jparams = {k: p.default for k, p in inspect.signature(jfn).parameters.items()}
    assert tparams == jparams


def test_registry_holds_tpulabs_model_rows():
    assert tuple(n for n in bench.REGISTRY if n not in bench.LAB_ROWS) == (
        "labformer_fwd", "labformer_train", "labformer_decode", "labformer_decode_int8",
        "labformer_decode_gqa2", "speculative_decode", "paged_engine", "paged_tick_overhead",
        "mesh_tick_overhead", "prefill_interleave", "obs_overhead", "journey_overhead", "obs_history_overhead",
        "fault_overhead", "journal_overhead", "autoscale_overhead",
        "spill_overhead", "handoff_overhead", "prefix_lookup", "train_step_overhead",
        "labvision_train",
        "flash_attention", "flash_attention_8k")
    assert bench.REGISTRY["labformer_decode_int8"].keywords == {"int8": True}
    assert bench.REGISTRY["labformer_decode_gqa2"].keywords == {"kv_heads": 2}
    assert bench.REGISTRY["flash_attention_8k"].keywords == {"s": 8192}
    for name in bench.REGISTRY:  # none is a row tpulab does not have
        assert name in inspect.getsource(jbench.run_benchmarks)
    assert "decode_recompiles" not in bench.REGISTRY and "decode_recompiles" in bench.__doc__


# ------------------------------------------------------------ rows on the CPU


def _rows(only, **kw):
    rows = list(bench.run_benchmarks(only=only, backend="cpu", **kw))
    for row in rows:
        assert row["device"] == "cpu" and row["vs_baseline"] is None and row["value"] > 0
        assert not {"model_flops", "mfu_pct_of_bf16_peak", "card"} & set(row)
    return rows


def test_forward_and_train_rows_on_the_cpu():
    (fwd,) = _rows("labformer_fwd", b=1, s=16, reps=1, dtype="float32")
    assert fwd["metric"] == "labformer_fwd_b1_s16_float32_tokens_per_s"
    assert fwd["unit"] == "tokens/s" and fwd["n_trials"] == 1
    (train,) = _rows("labformer_train", b=1, s=16, reps=1, dtype="float32")
    assert train["metric"] == "labformer_train_b1_s16_float32_tokens_per_s"
    (vision,) = _rows("labvision_train", b=2, reps=1)
    assert vision["metric"] == "labvision_train_b2_64x64_images_per_s"
    assert vision["unit"] == "images/s" and "analytic" in vision["flops_convention"]


def test_train_step_overhead_row_on_the_cpu():
    (row,) = _rows("train_step_overhead", steps=8, k=4, reps=3)
    assert row["metric"] == "train_step_b1_s16_k4_steps_per_s" and row["unit"] == "steps/s"
    assert row["sync_steps_per_s"] > 0 and row["speedup_vs_sync"] > 0
    assert row["n_trials"] == 3
    with pytest.raises(ValueError, match="multiple"):
        bench.bench_train_step(steps=6, k=4, backend="cpu")


def test_decode_rows_on_the_cpu():
    rows = _rows("labformer_decode", b=1, steps=3, reps=1, dtype="float32")
    assert [r["metric"] for r in rows] == [
        "labformer_decode_b1_3steps_float32_tokens_per_s",
        "labformer_decode_b1_3steps_float32_int8_tokens_per_s",
        "labformer_decode_b1_3steps_float32_gqa2_tokens_per_s"]


def test_speculative_row_on_the_cpu():
    (row,) = _rows("speculative_decode", steps=6, k=2, reps=1)
    assert row["metric"] == "speculative_decode_b1_6steps_k2_int8draft_tokens_per_s"
    assert row["plain_tokens_per_s"] > 0 and row["speedup_vs_plain"] > 0
    assert 0.0 <= row["mean_accepted"] <= 2.0 and row["n_trials"] == 3


def test_paged_rows_on_the_cpu():
    (eng,) = _rows("paged_engine", slots=2, steps=2, reps=1)
    assert eng["metric"] == "paged_engine_2slots_8reqs_tokens_per_s"
    assert eng["total_tokens"] == 16
    (tick,) = _rows("paged_tick_overhead", slots=2, steps=3, reps=1)
    assert tick["metric"] == "paged_tick_2slots_ticks_per_s"
    assert tick["inflight_depth"] == 1 and tick["sync_ticks_per_s"] > 0
    (pre,) = _rows("prefill_interleave", slots=2, reps=1)
    assert pre["metric"] == "prefill_interleave_2slots_tokens_per_s"
    assert pre["stall_ticks"] == 0 and pre["stall_ticks_sync"] > 0
    (look,) = _rows("prefix_lookup", short=1024, factor=4, reps=3)
    assert look["metric"] == "prefix_lookup_tokens_per_s" and look["long_tokens"] == 4096
    assert look["scaling_ratio"] < look["linear_bound"] == 8.0


def test_cache_rows_on_the_cpu(monkeypatch):
    """The spill and handoff rows at a tiny size: the engines run as on the
    card, in turns (a cold armed window that spills nothing, a handed-off
    stream equal to the unified one in every pair), and every sample is
    given the same time, since their 1 % and 3 % budgets mean nothing
    between CPU samples of a few ms (the card checks them for real:
    ``chip_smoke.py`` phase 9c)."""
    real, pairs = bench._paired, []

    def flat_clock(first, second, ticks):
        spent, done = real(first, second, ticks)
        pairs.append(spent)
        for side in ticks:  # each side's steps take 0.01 s between them
            side[:] = [0.01 / len(side)] * len(side)
        return [0.01, 0.01], done

    monkeypatch.setattr(bench, "_paired", flat_clock)
    (spill,) = _rows("spill_overhead", slots=2, steps=3, reps=1)
    assert spill["metric"] == "spill_overhead_2slots_ticks_per_s" and spill["value"] == 300.0
    assert spill["off_ticks_per_s"] == 300.0 and spill["spill_blocks"] == 64
    assert spill["overhead_pct_best"] == spill["overhead_pct_median"] == 0.0
    assert spill["n_trials"] == 3  # one round of 3 pairs: the armed side's
    (hand,) = _rows("handoff_overhead", prompt_len=33, steps=4, reps=1)
    assert hand["metric"] == "handoff_overhead_e2e_tokens_per_s" and hand["prompt_len"] == 33
    assert hand["value"] == hand["unified_tokens_per_s"] == 400.0
    # each row: one untimed pair first, then one round of 3 pairs
    assert len(pairs) == 2 * (1 + 3) and all(min(p) > 0 for p in pairs)


def test_obs_and_fault_rows_on_the_cpu(monkeypatch):
    """The obs, journey and fault rows at a tiny size with a flat clock
    (their budgets are checked on the card, ``chip_smoke.py`` phase 9c):
    the "on" engines record (the journey row completes its journeys), the
    "off" ones record nothing, and the fault row leaves the injector off."""
    from tpulab_torch import faults, obs

    real, pairs = bench._paired, []

    def flat_clock(first, second, ticks):
        spent, done = real(first, second, ticks)
        pairs.append(spent)
        for side in ticks:  # each side's steps take 0.01 s between them
            side[:] = [0.01 / len(side)] * len(side)
        return [0.01, 0.01], done

    monkeypatch.setattr(bench, "_paired", flat_clock)
    h = obs.REGISTRY.get("ttft_seconds")
    n0 = h.snapshot()["count"]
    (row,) = _rows("obs_overhead", slots=2, steps=3, reps=1)
    assert row["metric"] == "obs_overhead_2slots_ticks_per_s" and row["value"] == 300.0
    assert row["off_ticks_per_s"] == 300.0 and row["overhead_pct_best"] == 0.0
    # 4 pairs of one obs engine of 2 requests, each past its first token
    assert h.snapshot()["count"] - n0 == 4 * 2
    (row,) = _rows("journey_overhead", slots=2, steps=3, reps=1)
    assert row["metric"] == "journey_overhead_2slots_ticks_per_s"
    assert row["journeys_completed"] >= 2
    (row,) = _rows("fault_overhead", slots=2, steps=3, reps=1)
    assert row["metric"] == "fault_overhead_2slots_ticks_per_s"
    assert row["enabled_idle_ticks_per_s"] == row["value"] == 300.0
    assert not faults.ACTIVE and not faults.INJECTOR.enabled
    assert len(pairs) == 3 * (1 + 3) and all(min(p) > 0 for p in pairs)


def test_control_plane_rows_on_the_cpu(monkeypatch):
    """The history, journal and autoscale rows at a tiny size with a flat
    clock (their 3 % and 1 % budgets are checked on the card,
    ``chip_smoke.py`` phase 9c): the history row's sampler ticks and
    evaluates the whole catalog, the journal row writes its records in a
    directory it removes, and no row leaves process-wide state behind."""
    from tpulab_torch import obs

    real, pairs = bench._paired, []

    def flat_clock(first, second, ticks):
        spent, done = real(first, second, ticks)
        pairs.append(spent)
        for side in ticks:  # each side's steps take 0.01 s between them
            assert len(side) == 3
            side[:] = [0.01 / 3] * 3
        return [0.01, 0.01], done

    monkeypatch.setattr(bench, "_paired", flat_clock)
    n_hist, cap = obs.HISTORY.total_samples, obs.TRACER.capacity
    (row,) = _rows("obs_history_overhead", slots=2, steps=3, reps=1, sampler_interval_s=1e-9)
    assert row["metric"] == "obs_history_overhead_2slots_ticks_per_s" and row["value"] == 300.0
    assert row["history_samples"] == 4 * 3 and row["alert_rules"] == 11
    assert row["sampler_interval_ms"] == 1e-9 * 1e3 and row["sampler_every_ticks"] == 1
    assert row["overhead_pct_best"] == 0.0
    assert obs.HISTORY.total_samples == n_hist and obs.TRACER.capacity == cap
    (row,) = _rows("journal_overhead", slots=2, steps=3, reps=1)
    assert row["metric"] == "journal_overhead_2slots_ticks_per_s" and row["ckpt_every"] == 16
    assert row["value"] == row["off_ticks_per_s"] == 300.0
    (row,) = _rows("autoscale_overhead", slots=2, steps=3, reps=1)
    assert row["metric"] == "autoscale_overhead_2slots_ticks_per_s"
    assert row["eval_every_ticks"] == 8 and row["value"] == 300.0
    assert len(pairs) == 3 * (1 + 3) and all(min(p) > 0 for p in pairs)


def test_paired_runs_two_generators_in_turns(monkeypatch):
    """One step of each in turn until both end, the side that goes first
    swapping every round; each side is charged the clock time of its own
    steps only (each step's, in ``ticks``), and gets its generator's
    return."""
    log, ticks = [], iter(range(1000))

    class Clock:
        @staticmethod
        def perf_counter():
            return float(next(ticks))

    def gen(name, n):
        for i in range(n):
            log.append(f"{name}{i}")
            yield
        return name

    monkeypatch.setattr(bench, "time", Clock)
    spent, done = bench._paired(gen("a", 3), gen("b", 1))
    assert log == ["a0", "b0", "a1", "a2"] and done == ["a", "b"]
    assert spent == [4.0, 2.0]  # one clock tick a resumption, the last one ends it
    log.clear()
    steps = ([], [])
    bench._paired(gen("a", 3), gen("b", 3), steps)
    assert log == ["a0", "b0", "b1", "a1", "a2", "b2"]
    assert steps == ([1.0] * 3, [1.0] * 3)  # the ending resumptions are not steps


def test_step_overhead_takes_each_steps_median():
    """The overhead sums each step's median over the pairs of the pair's
    difference at that step: a hiccup on one step of a pair spoils
    nothing, a step slower in every pair is kept in full; sides that take
    different steps are held step by step on their own medians; the
    windows' medians are reported beside it."""
    off = [[1.0, 1.0, 9.0], [1.0, 9.0, 1.0], [9.0, 1.0, 1.0]]
    on = [[1.5, 1.0, 9.0], [1.5, 9.0, 1.0], [9.0, 1.0, 1.0]]
    assert bench._step_overhead(on, off) == pytest.approx((0.5 / 3.0, 3.5, 3.0))
    assert bench._step_overhead([[1.0] * 4] * 3, off) == pytest.approx((1 / 3, 4.0, 3.0))
    samples = iter(zip(off, on))
    times, best = bench._best_of_reps(lambda on_first: dict(zip((False, True), next(samples))),
                                      3, 1.0)
    assert times == {False: [11.0] * 3, True: [11.5, 11.5, 11.0]}
    assert best == pytest.approx(0.5 / 3.0)
    assert bench._overhead_fields({False: [11.0, 11.0, 11.0], True: [11.5, 11.5, 11.0]},
                                  0.5 / 3.0) == {"overhead_pct_median": 4.55,
                                                 "overhead_pct_best": 16.67}


@pytest.mark.parametrize("budget,slower,passes", [
    (0.01, 1.005, True), (0.01, 1.02, False), (0.03, 1.02, True), (0.03, 1.04, False)])
def test_overhead_budget_is_best_of_reps(budget, slower, passes):
    """The budget holds the "on" side against the "off" one over every pair
    of retried rounds, and raises past it: a row cannot pass a slower side."""
    firsts = []

    def pair(on_first):
        firsts.append(on_first)
        # the k-th pair's second step is 1.0x, 1.1x or 1.2x its floor on both
        # sides (the host's drift: the pair's difference cancels it); every
        # third pair's "on" side has a hiccup on its first step (the median drops it)
        extra = 0.1 * (len(firsts) % 3)
        hiccup = 5.0 if len(firsts) % 3 == 1 else 0.0
        return {False: [0.5, 0.5 + extra], True: [0.5 + hiccup, slower - 0.5 + extra]}
    if passes:
        times, best = bench._best_of_reps(pair, 3, budget)
        assert len(times[True]) == len(times[False]) == 3
        assert best == pytest.approx((slower - 1.0) / 1.1)  # off: 0.5 + median(0.6, 0.7, 0.5)
    else:
        with pytest.raises(RuntimeError, match="budget"):
            bench._best_of_reps(pair, 3, budget)
        assert len(firsts) == 3 * 5  # five rounds before it gives up
    assert firsts[:3] == [False, True, False]  # each pair swaps which side steps first


def test_flash_row_on_the_cpu():
    """``only="flash_attention"`` would also run the 8k row at its bound
    s=8192, so the row is called here as the registry holds it."""
    row = bench.REGISTRY["flash_attention"](s=64, reps=1, backend="cpu")
    assert row["metric"] == "flash_attention_s64_h8_d64_bf16_median_ms"
    assert row["device"] == "cpu" and row["unit"] == "ms" and row["n_trials"] == 5
    assert row["value"] > 0 and "model_flops" not in row


def test_rows_refuse_an_error_row():
    """A failing row raises: no error is turned into a row."""
    with pytest.raises(Exception):
        list(bench.run_benchmarks(only="labformer_fwd", backend="cpu", b=1, s=16, reps=1,
                                  dtype="float16"))
    assert np.isfinite(troof.labformer_fwd_flops(tlf.LabformerConfig(), 1, 1))


def test_chip_smoke_phase9_rehearses_on_the_cpu():
    """chip_smoke.py's phase 9 at a tiny size on the CPU (plain versions):
    speculative and lookup streams, the speculative engine against the
    engines without speculation, the bench rows through the CLI, B4's
    long-context rows on a tail and whole."""
    import chip_smoke

    tiny = dict(chip_smoke.FULL_SIZES)
    tiny.update(serving=dict(d_model=64, n_heads=4, n_layers=2, d_ff=128, max_seq=256),
                paged=dict(d_model=64, n_heads=4, n_kv_heads=2, n_layers=2, d_ff=128,
                           max_seq=256),
                spec_steps=12, spec_prompt=16, spec_reps=1,
                bench_model=dict(b=1, s=16, steps=3, reps=1, dtype="float32", slots=2, k=2,
                                 short=256),
                bench_groups=tuple(g for g in chip_smoke.BENCH_GROUPS
                                   if g not in ("flash_attention", "spill_overhead",
                                                "handoff_overhead", "obs_overhead",
                                                "journey_overhead", "fault_overhead",
                                                "obs_history_overhead", "journal_overhead",
                                                "autoscale_overhead")),
                b4_long=((256, 64), (128, 0)))
    long_rows, out = chip_smoke.run_spec_and_bench_path(tiny, torch.device("cpu"), "cpu", "cpu")
    assert [r["rows_held"] for r in long_rows] == [[192, 256], [0, 128]]
    assert all(r["err_over_tolerance"] <= 1 for r in long_rows)
    assert out["speculative"]["small_trained"]["bit_equal"]
    eng = out["engine"]["small_trained"]
    assert eng["spec_fetches"] == eng["verify_passes"] > 0
    assert {r["metric"].split("_b")[0] for r in out["bench"]["rows"]} >= {
        "labformer_fwd", "labformer_train", "labformer_decode", "speculative_decode"}
    assert len(out["bench"]["rows"]) == 10  # every model row but the two flash rows


def test_gate_noise_runs_every_round_on_the_cpu():
    """``bench_gate_noise`` runs all five rounds of a row and of the fault
    row's A/A pair, both estimates after each, and puts the gate back."""
    from tpulab_torch import bench_gate_noise, faults

    gate = bench._best_of_reps
    lines = list(bench_gate_noise.run(rows=("autoscale_overhead",), repeat=1, backend="cpu",
                                      slots=2, steps=3, reps=1))
    assert [(x["row"], x["aa"]) for x in lines] == [("fault_overhead", True),
                                                     ("autoscale_overhead", False)]
    assert all(len(x["paired_median_pct_by_round"]) == len(x["least_pct_by_round"]) == 5
               for x in lines)
    assert bench._best_of_reps is gate and not faults.ACTIVE
