"""One run of one cell: set-up, the measured window, the traced readings,
the comparison that decides ``correct``, and the result line.

Everything that belongs to one configuration, traffic mix or metric is a
file of its own, found by the name ``BENCHMARK.json`` gives it:
``configs/<config>.json``, ``traffic/<traffic>.json`` and
``metrics/<metric>.py``. A traffic mix is data; the code it names is found
by name too: its ``entry`` (``entries/<entry>.py``: how a call drives the
program, and how its answers are judged) and its ``pool.kind``
(``pools/<kind>.py``: the camera poses of its frames). This file only sets
up, loops over the window and reads the metrics.
"""

from __future__ import annotations

import importlib.util
import json
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch

from perfbench import trace
from perfbench.inputs import scene as scene_mod
from perfbench.inputs.render import render_u8
from perfbench.reference import judge

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "aprilslam_tpu", "bench_torch", "chip_smoke", "tools")


def load_json(path: Path) -> dict:
    return json.loads(Path(path).read_text())


def benchmark() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def find_cell(name: str) -> dict:
    for w in benchmark()["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(name: str) -> dict:
    return load_json(HERE / "configs" / f"{name}.json")


def traffic(name: str) -> dict:
    return load_json(HERE / "traffic" / f"{name}.json")


def limits() -> dict:
    return load_json(HERE / "reference" / "limits.json")


def load(kind: str, name: str):
    """The module ``<kind>/<name>.py`` of the benchmark, loaded from its file."""
    path = HERE / kind / f"{name}.py"
    if not path.is_file():
        raise KeyError(f"no {kind}/{name}.py")
    spec = importlib.util.spec_from_file_location(f"perfbench_{kind}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str):
    """``read(records) -> number or None`` of ``metrics/<name>.py``."""
    return load("metrics", name).read


def cell_metrics(cell: str, kind: str) -> list[dict]:
    """The ``end_to_end`` or ``per_layer`` metrics this cell reports."""
    b = benchmark()
    mine = [m for m in b["end_to_end"] if cell in m.get("workloads", [cell])]
    if kind == "end_to_end":
        return mine
    names = {m["name"] for m in mine}
    return [m for m in b["per_layer"] if cell in m.get("workloads", [cell] if m["moves"] in names else [])]


def forbidden_modules(modules=None) -> list[str]:
    """Loaded modules whose top-level name is the JAX stack's, the JAX
    package's or another of the repo's own harnesses'."""
    mods = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in mods if m.split(".")[0] in FORBIDDEN})


@dataclass
class Inputs:
    scene: scene_mod.Scene
    K: np.ndarray
    width: int
    height: int
    cam_pos: np.ndarray
    cam_rot: np.ndarray
    frames: torch.Tensor  # (pool, H, W) uint8 on the device


def make_inputs(cfg: dict, trf: dict, seed: int, device: torch.device) -> Inputs:
    """The cell's scene, camera poses and rendered frame pool, from the seed."""
    raw = load_json(HERE / "inputs" / cfg["scene"]["file"])
    pct = cfg["scene"].get("randomize_percentage")
    if pct:
        raw = scene_mod.randomize_scene(raw, pct, seed)
    scene = scene_mod.Scene(raw)
    W, H = cfg["resolution"]
    K = scene_mod.intrinsics(W, H, float(raw["fov_y"]))
    pos, rot = load("pools", trf["pool"]["kind"]).poses(trf["pool"], seed)
    frames = render_u8(scene, pos, rot, K, H, W, device)
    return Inputs(scene, K, W, H, pos, rot, frames)


def _pack(tensors: dict) -> tuple[torch.Tensor, list]:
    """One float32 device tensor of every field, and how to unpack it."""
    spec = [(k, v.shape, v.dtype) for k, v in tensors.items()]
    return torch.cat([v.reshape(-1).to(torch.float32) for v in tensors.values()]), spec


def _unpack(flat: np.ndarray, spec: list) -> dict:
    out, i = {}, 0
    for k, shape, dtype in spec:
        n = int(np.prod(shape))
        a = flat[i:i + n].reshape(tuple(shape))
        out[k] = a.astype(np.bool_) if dtype == torch.bool else (
            np.rint(a).astype(np.int64) if not dtype.is_floating_point else a)
        i += n
    return out


def _host(tensors: dict) -> dict:
    """Copy a call's outputs to the host in one transfer (it waits for them)."""
    flat, spec = _pack(tensors)
    return _unpack(flat.cpu().numpy(), spec)


class Caller:
    """Calls into the program through the traffic's entry; call k takes the
    pool's frames ``(k mod calls per pool) * F`` onwards, and session
    traffic starts a session (``reset()``) every ``session_calls`` calls.
    A planted fault (the tests and ``control.py`` only) breaks the answers
    where they are produced: ``half_batch`` drops the second half of each
    call's frames, ``altered`` changes the first answer the program vouches
    for, ``frozen_state`` (an entry's own) returns the state unchanged."""

    def __init__(self, cfg: dict, trf: dict, inputs: Inputs, device: torch.device, fault: str | None = None):
        self.F = int(trf["frames_per_call"])
        self.per_pool = inputs.frames.shape[0] // self.F
        self.session = int(trf.get("session_calls", 0))
        self.inputs = inputs
        self.fault = fault
        self.entry = load("entries", trf["entry"])
        self.program = self.entry.Program(cfg, inputs, device, fault)

    def pool_index(self, k: int) -> np.ndarray:
        s = (k % self.per_pool) * self.F
        return np.arange(s, s + self.F)

    def reset(self) -> None:
        self.program.reset()

    def run(self, k: int) -> dict:
        """Call k on the device, without waiting for it; returns its outputs."""
        if self.session and k % self.session == 0:
            self.program.reset()
        s = (k % self.per_pool) * self.F
        return self.program.run(self.inputs.frames[s:s + self.F])

    def call(self, k: int) -> dict:
        """Call k, its outputs copied to the host."""
        ans = _host(self.run(k))
        if self.fault == "half_batch":
            half = self.F // 2
            ans["det_ids"][half:] = -1
            ans["det_ok"][half:] = False
            for key in self.entry.FRAME_FLAGS:
                ans[key][half:] = False
        elif self.fault == "altered":
            good = (ans["det_ids"] >= 0) & ans["det_ok"]
            b, d = np.argwhere(good)[0] if good.any() else (0, 0)
            ans["det_ids"][b, d] += 1
            self.entry.alter(ans, b, d)
        return ans


@dataclass
class Window:
    seconds: float = 0.0
    calls: list = field(default_factory=list)  # (k, host seconds, answers)


def measure(caller: Caller, first_k: int, seconds: float) -> Window:
    """Closed loop, one call in flight, until ``seconds`` have passed."""
    w = Window()
    k = first_k
    t_start = time.perf_counter()
    while True:
        t0 = time.perf_counter()
        ans = caller.call(k)
        t1 = time.perf_counter()
        w.calls.append((k, t1 - t0, ans))
        k += 1
        if t1 - t_start >= seconds:
            break
    w.seconds = t1 - t_start
    return w


def traced(caller: Caller, trf: dict, next_k: int) -> dict:
    """The device trace, the dispatched operations and the host syncs of a
    few calls after the window. Session traffic starts a fresh session for
    each reading, so each reads the same calls of a session."""
    tr = trf["trace"]
    F = caller.F
    k = next_k
    if caller.session:
        k = (k // caller.session + 1) * caller.session
    for j in range(tr.get("profile_skip", 0)):
        caller.call(k + j)
    k0 = k + tr.get("profile_skip", 0)
    n = tr["profile_calls"]
    rec = trace.profile(lambda: [caller.call(k0 + j) for j in range(n)])
    rec["frames"] = n * F
    k = k0 + n
    if caller.session:
        k = (k // caller.session + 1) * caller.session
    c = tr["count_calls"]
    ops = trace.count_ops(lambda: [caller.call(k + j) for j in range(c)])
    k += c
    if caller.session:
        k = (k // caller.session + 1) * caller.session
    torch.cuda.synchronize()
    syncs = trace.count_syncs(lambda: [caller.call(k + j) for j in range(c)])
    return {"trace": rec, "ops": ops, "ops_frames": c * F, "syncs": dict(syncs), "sync_calls": c}


@dataclass
class Judged:
    """What an entry's ``judge_answers`` reads: the judged calls, their
    frames' ground truth, and the detections (the control's, with
    ``control`` set to its dtype)."""

    inputs: Inputs
    calls: list
    answers: list
    gt: dict
    ids: np.ndarray
    corners: np.ndarray
    ok: np.ndarray
    F: int
    session: int
    control: torch.dtype | None

    @property
    def tag_size(self) -> float:
        return self.inputs.scene.tag_size_inner

    def stack(self, key: str) -> np.ndarray:
        return np.concatenate([a[key] for a in self.answers])


def judge_window(cfg: dict, trf: dict, inputs: Inputs, caller: Caller, window: Window, seed: int,
                 control: str | None = None) -> dict:
    """Every number the comparison reads over the window's answers (a
    sample of calls drawn from the seed where the traffic says so). With
    ``control`` (a dtype name), the reference computed in that dtype takes
    the program's place."""
    lim = limits()
    calls = window.calls
    n_judge = int(trf.get("judge_calls", 0))
    if n_judge and len(calls) > n_judge:
        pick = np.sort(np.random.default_rng(seed).choice(len(calls), n_judge, replace=False))
        calls = [calls[i] for i in pick]
    answers = [c[2] for c in calls]
    idx = np.concatenate([caller.pool_index(c[0]) for c in calls])
    gt = judge.ground_truth(inputs.scene, inputs.cam_pos[idx], inputs.cam_rot[idx], inputs.K)
    stack = lambda key: np.concatenate([a[key] for a in answers])  # noqa: E731
    ids, corners, ok = stack("det_ids"), stack("det_corners"), stack("det_ok")
    dt = getattr(torch, control) if control else None
    if control:
        gtc = judge.ground_truth(inputs.scene, inputs.cam_pos[idx], inputs.cam_rot[idx], inputs.K, dtype=dt)
        c = judge.control_detections(gtc, inputs.scene, inputs.width, inputs.height, dt, ids.shape[1])
        ids, corners, ok = c["ids"].numpy(), c["corners"].to(torch.float64).numpy(), c["ok"].numpy()
    nums = judge.judge_detections(ids, corners, ok, gt, inputs.scene, inputs.width, inputs.height,
                                  lim["margin_px"], lim["match_px"])
    w = Judged(inputs, calls, answers, gt, ids, corners, ok, caller.F, caller.session, dt)
    nums.update(caller.entry.judge_answers(w))
    return nums


def checks(cfg: dict, nums: dict) -> dict:
    """Each number compared, beside its limit: the benchmark's own limits,
    and the configuration's stated guarantees."""
    out = {}
    bounds = {**limits()["limits"], **{k: {kk: vv for kk, vv in v.items() if kk in ("max", "min")}
                                       for k, v in cfg["guarantees"].items()}}
    for name, b in bounds.items():
        if name in nums:
            out[name] = {"value": nums[name], **b}
    return out


def holds(c: dict) -> bool:
    v = c["value"]
    if v is None or v != v:
        return False
    return ("max" not in c or v <= c["max"]) and ("min" not in c or v >= c["min"])


def run_cell(name, seed: int, seconds: float, trace_on: bool, device: torch.device, t_start: float,
             fault: str | None = None, overrides: dict | None = None, log=print) -> tuple[dict, dict]:
    """One run of cell ``name`` of ``BENCHMARK.json``, or of a cell given
    whole as a dict of the same keys (a tool's, or a test's, that the
    benchmark does not list). Returns (the result line, the run's state for
    a caller that reads more from it: inputs, caller, window)."""
    cell = find_cell(name) if isinstance(name, str) else name
    name = cell["name"]
    cfg = config(cell["config"])
    trf = traffic(cell["traffic"])
    for k, v in (overrides or {}).items():
        target = cfg if k in cfg else trf
        target[k] = v
    split = {"import_s": time.perf_counter() - t_start}
    t = time.perf_counter()
    if device.type == "cuda":
        from aprilslam_tpu_torch.ops import ccl

        ccl.build_ccl()
    split["ccl_build_s"] = time.perf_counter() - t
    t = time.perf_counter()
    inputs = make_inputs(cfg, trf, seed, device)
    _sync(device)
    split["inputs_s"] = time.perf_counter() - t
    t = time.perf_counter()
    caller = Caller(cfg, trf, inputs, device, fault)
    split["build_s"] = time.perf_counter() - t
    t = time.perf_counter()
    w0 = int(trf["warmup_calls"])
    for k in range(w0):
        caller.call(k)
    _sync(device)
    split["warmup_s"] = time.perf_counter() - t
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = time.perf_counter() - t_start
    log(json.dumps({"setup_split": {k: round(v, 4) for k, v in split.items()}, "setup_s": setup_s}))

    window = measure(caller, w0, seconds)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    frames = len(window.calls) * caller.F
    rec = {"setup_s": setup_s, "window_s": window.seconds, "frames": frames, "frames_per_call": caller.F,
           "calls_s": [c[1] for c in window.calls], "height": inputs.height, "width": inputs.width,
           "decimate": int(cfg["detector"]["quad_decimate"])}
    out = {}
    if trace_on:
        rec.update(traced(caller, trf, w0 + len(window.calls)))
        out["breakdown"] = rec["trace"]["breakdown"]
    kind = "per_layer" if trace_on else "end_to_end"
    metrics = {}
    for m in cell_metrics(name, kind):
        v = metric_reader(m["name"])(rec)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    state = {"inputs": inputs, "caller": caller, "window": window, "cfg": cfg, "trf": trf, "rec": rec}
    if device.type == "cuda":
        caller.reset()
        torch.cuda.empty_cache()
    t = time.perf_counter()
    nums = judge_window(cfg, trf, inputs, caller, window, seed)
    log(json.dumps({"judge_s": round(time.perf_counter() - t, 3)}))
    chk = checks(cfg, nums)
    correct = all(holds(c) for c in chk.values())
    dev = {"platform": "gpu" if device.type == "cuda" else "cpu",
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": int(cell["chips"]), "memory_peak_bytes": int(peak)}
    if trace_on:
        dev["busy_s"] = rec["trace"]["busy_s"]
        dev["window_s"] = rec["trace"]["window_s"]
    result = {"correct": correct, "attempted": frames, "failed": 0, "metrics": metrics, "device": dev}
    result.update(out)
    result["checks"] = chk
    state["nums"] = nums
    return result, state


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
