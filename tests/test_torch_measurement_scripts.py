"""The port's measurement scripts (``fedml_tpu_torch/scripts/``), the
counterpart of the reference's ``tests/test_measurement_scripts.py``:
each script runs in a subprocess at ``--platform cpu --tiny``-class
shapes and its JSON output contract is held, as the committed evidence
is parsed by it; ``convergence_summarize`` rebuilds a summary from
partial and complete curves. The reference marks its subprocess smokes
slow (its XLA compiles take minutes); here each takes a few seconds, so
all are tier 1. Without ``--platform cpu`` a script fails on a host with
no card rather than fall back."""

import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(args, timeout=600, ok=True):
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    r = subprocess.run([sys.executable, "-m"] + args, capture_output=True,
                       text=True, cwd=REPO, timeout=timeout, env=env)
    if ok:
        assert r.returncode == 0, (r.stdout[-2000:], r.stderr[-2000:])
    return r


def _lines(r):
    return [json.loads(ln) for ln in r.stdout.splitlines()
            if ln.startswith("{")]


def _on_cpu(rec):
    assert rec["platform"] == "cpu" and rec["device"] == "cpu", rec
    assert rec["timer"] == "host_clock" and rec["power_limit_w"] is None, rec


def test_profile_lane_step_smoke():
    r = _run(["fedml_tpu_torch.scripts.profile_lane_step", "--platform",
              "cpu", "--tiny", "--fp32", "--repeats", "2", "--batch", "8"])
    lines = _lines(r)
    names = {k for ln in lines for k in ln}
    for want in ("A_one_model_bs512", "B_vmap_lanes",
                 "B2_packed_lanes[blockdiag]", "B2_packed_lanes[pallas]",
                 "C_plus_augment", "D_full_lane_body",
                 "E_one_model_frozen_bn", "R_timer_floor", "breakdown"):
        assert want in names, (want, names)
    (bd,) = [ln["breakdown"] for ln in lines if "breakdown" in ln]
    for k in ("conv_ceiling_ms", "lane_penalty_ms", "augment_ms",
              "opt_flush_ms", "lane_penalty_x"):
        assert k in bd
    # a negative derived component must be flagged, never printed as a
    # cost
    negative = [k for k in ("lane_penalty_ms", "augment_ms",
                            "opt_flush_ms") if bd[k] < 0]
    assert set(negative) <= set(bd.get("inversions", [])), (negative, bd)
    (floor,) = [ln for ln in lines if "R_timer_floor" in ln]
    _on_cpu(floor)
    assert floor["b1_launches"] == 0  # the plain versions on the CPU
    assert all(ln[k]["mfu"] is None for ln in lines for k in ln
               if k.startswith(("A_", "B", "C_", "D_", "E_")))


def test_bench_lm_smoke():
    r = _run(["fedml_tpu_torch.scripts.bench_lm", "--platform", "cpu",
              "--tiny", "--repeats", "2"])
    rec = _lines(r)[-1]
    for k in ("metric", "mfu", "achieved_tflops", "tokens_per_s",
              "ms_per_step", "attention_launches_per_step"):
        assert k in rec, rec
    assert rec["tokens_per_s"] > 0 and rec["ms_per_step"] > 0
    # no device metric from a CPU run
    assert rec["mfu"] is None and rec["achieved_tflops"] is None
    _on_cpu(rec)


def test_convergence_smoke(tmp_path):
    # 2 configs x 4 rounds at toy shapes, incl. the plateau-agreement
    # assert (exit code 1 = diverged; _run asserts 0)
    _run(["fedml_tpu_torch.scripts.convergence", "--platform", "cpu",
          "--tiny", "--tol", "0.5", "--configs", "fp32_lanes,fp32_flat",
          "--outdir", str(tmp_path)])
    summary = json.loads((tmp_path / "summary.json").read_text())
    assert summary["agree"] is True
    assert {x["name"] for x in summary["results"]} == {"fp32_lanes",
                                                       "fp32_flat"}
    for cfg in ("fp32_lanes", "fp32_flat"):
        curve = [json.loads(ln) for ln in
                 (tmp_path / f"{cfg}.jsonl").read_text().splitlines()]
        assert len(curve) == 4
        assert all("train_acc" in c and "train_loss" in c for c in curve)


def _write_curve(path, rounds, acc):
    with open(path, "w") as f:
        for r in range(rounds):
            f.write(json.dumps({"round": r, "train_acc": acc,
                                "train_loss": 2.0 - acc}) + "\n")


def _summarize(tmp_path):
    return _run(["fedml_tpu_torch.scripts.convergence_summarize",
                 "--outdir", str(tmp_path), "--tail", "3", "--tol", "0.05",
                 "--min_rounds", "10"], timeout=120, ok=False)


def test_convergence_summarize_partial_run(tmp_path):
    # the tool exists for killed runs: curves alone must yield an
    # honestly-labelled summary
    _write_curve(tmp_path / "bf16_lanes3.jsonl", 12, 0.41)
    _write_curve(tmp_path / "fp32_lanes.jsonl", 12, 0.42)
    _write_curve(tmp_path / "fp32_flat.jsonl", 5, 0.40)  # killed early
    r = _summarize(tmp_path)
    # agreement holds but one curve is short of min_rounds -> exit 1,
    # summary.json written anyway
    assert r.returncode == 1, (r.stdout, r.stderr)
    summary = json.loads((tmp_path / "summary.json").read_text())
    by_name = {x["name"]: x for x in summary["results"]}
    assert by_name["bf16_lanes3"]["mode"] == "lanes3"
    assert by_name["fp32_lanes"]["mode"] == "lanes"
    assert by_name["fp32_flat"]["mode"] == "flat"
    assert by_name["fp32_flat"]["complete"] is False
    assert by_name["fp32_lanes"]["complete"] is True
    assert summary["agree"] is True
    assert summary["all_complete"] is False


def test_convergence_summarize_complete_agreeing(tmp_path):
    _write_curve(tmp_path / "bf16_lanes.jsonl", 10, 0.41)
    _write_curve(tmp_path / "bf16_flat.jsonl", 10, 0.42)
    r = _summarize(tmp_path)
    assert r.returncode == 0, (r.stdout, r.stderr)
    summary = json.loads((tmp_path / "summary.json").read_text())
    assert summary["agree"] is True and summary["all_complete"] is True


def test_bench_gkt_smoke():
    r = _run(["fedml_tpu_torch.scripts.bench_gkt", "--platform", "cpu",
              "--tiny", "--rounds", "1"])
    rec = _lines(r)[-1]
    for k in ("metric", "value", "unit", "rounds_per_hour"):
        assert k in rec, rec
    assert rec["value"] > 0
    _on_cpu(rec)


def test_bench_lane_conv_smoke():
    # the lowering shoot-out: a tiny one-stage matrix incl. the numerics
    # gate over every candidate
    r = _run(["fedml_tpu_torch.scripts.bench_lane_conv", "--platform",
              "cpu", "--tiny"])
    lines = _lines(r)
    errors = [ln for ln in lines if "ERROR" in ln or "SKIP" in ln]
    assert not errors, errors
    done = {(ln["cand"], ln["pass"]) for ln in lines
            if "cand" in ln and "ms" in ln}
    # every candidate survives the numerics gate and times BOTH passes
    for cand in ("vmap", "packed", "packed_all", "bgc", "im2col",
                 "shared", "pallas"):
        assert (cand, "fwd") in done and (cand, "fwd+bwd") in done, (
            cand, done)
    assert {"stage": "s1", "cand": "auto", "same_as": "bgc"} in lines
    _on_cpu(lines[0])


def test_hw_smoke_flash_smoke():
    r = _run(["fedml_tpu_torch.scripts.hw_smoke_flash", "--platform", "cpu",
              "--tiny"])
    rec = _lines(r)[-1]
    assert {(c["D"], c["causal"]) for c in rec["cases"]} == {
        (128, False), (128, True), (64, False), (64, True)}
    assert rec["launches"] == {"fwd": 0, "dq": 0, "dkv": 0}
    _on_cpu(rec)


@pytest.mark.parametrize("script", ["bench_lm", "hw_smoke_flash"])
def test_scripts_need_a_card_without_platform_cpu(script):
    r = _run([f"fedml_tpu_torch.scripts.{script}", "--tiny"], ok=False)
    assert r.returncode != 0
    assert "no CUDA device" in r.stderr, r.stderr[-2000:]
