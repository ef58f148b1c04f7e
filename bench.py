"""Benchmark: bunny.txt at 1024x768 on the default JAX backend (a GPU).

Protocol (BASELINE.md): p50 frame time over repeated frames at a fixed
deterministic state; Mrays/sec counts primary rays + shadow rays actually
traced. The baseline is the native C++ CPU oracle (the OpenCL-on-CPU
stand-in) running the same scene/resolution on this host.

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": "Mrays/s", "vs_baseline": N, ...}

Timing: host wall clock around each frame, ended by block_until_ready
(utils.timing). Needs the reference scene corpus (REF_ASSETS); chip_smoke.py
is the in-repository check of the flagship frame on the card.
"""

from __future__ import annotations

import json
import os
import pathlib
import subprocess
import sys
import time

REPO = pathlib.Path(__file__).resolve().parent
REF = pathlib.Path(os.environ.get("REF_ASSETS", "/root/reference"))
# Protocol resolution (BASELINE.md). RPT_BENCH_SIZE overrides ONLY for smoke
# tests of the bench flow itself on slow hosts; official numbers are 1024x768.
W, H = (int(x) for x in
        os.environ.get("RPT_BENCH_SIZE", "1024x768").lower().split("x"))
FRAMES = 120   # timed frames (BASELINE.md: >= 100 frames)
# The committed cache holds ONLY the official protocol measurement; smoke runs
# at other resolutions cache in /tmp so they can never clobber it.
BASELINE_CACHE = (REPO / "BASELINE_MEASURED.json" if (W, H) == (1024, 768)
                  else pathlib.Path(f"/tmp/baseline_{W}x{H}.json"))


def log(*a):
    print(*a, file=sys.stderr, flush=True)


# Sections publish into this dict AS THEY COMPLETE so a wedge in a later
# section still reports everything already earned.
PARTIAL: dict = {}


def _watchdog(seconds: float):
    """Emit an honest JSON line and exit if the run wedges (an external kill
    would leave NO artifact at all). Any sections that completed before the
    wedge are included via PARTIAL."""
    import os
    import threading

    def fire():
        line = {
            "metric": f"total Mrays/s, bunny.txt {W}x{H} (primary+shadow), p50",
            "value": 0.0,
            "unit": "Mrays/s",
            "vs_baseline": 0.0,
        }
        line.update(PARTIAL)
        line["error"] = (f"bench wedged for {seconds:.0f}s"
                         + (" after the headline was measured (partial "
                            "results above are valid)" if PARTIAL
                            else " (device unreachable?)"))
        # The main thread mutates PARTIAL's nested dicts in place; a dump
        # racing an insertion raises RuntimeError, which would kill THIS
        # thread before it prints anything -- the exact no-artifact outcome
        # the watchdog exists to prevent. Retry (mutation windows are tiny),
        # then fall back to a minimal line.
        for _try in range(5):
            try:
                payload = json.dumps(line)
                break
            except RuntimeError:
                time.sleep(0.05)
        else:
            payload = json.dumps({
                "metric": line["metric"], "value": 0.0, "unit": "Mrays/s",
                "vs_baseline": 0.0,
                "error": f"bench wedged for {seconds:.0f}s (partial results "
                         "unserializable: racing mutation)"})
        print(payload, flush=True)
        os._exit(3)

    t = threading.Timer(seconds, fire)
    t.daemon = True
    t.start()
    return t


def cpu_fallback(backend: str, pinned: str | None) -> bool:
    """True when an official (unpinned) run landed on the CPU backend.

    A broken accelerator setup can let jax fall back to the cpu backend --
    which would silently spend the whole watchdog budget rendering CPU
    frames and label them as an official artifact. Smoke runs pin
    RPT_PLATFORM=cpu explicitly and are exempt; a set-but-EMPTY pin counts
    as unpinned, because the platform pin itself (main) only applies to
    non-empty values."""
    return not pinned and backend == "cpu"


def measure_ours(scene, meta):
    """BASELINE.md protocol: p50/p95 frame time over >= 100 frames, each
    timed from dispatch to block_until_ready (utils.timing)."""
    from relativitypathtracer_tpu.render import FrameState, build_render_fn
    from relativitypathtracer_tpu.utils.timing import frame_times_ms, percentile

    render = build_render_fn(meta, W, H, meta.default_interval, 1, True)
    samples, _, (img, aux) = frame_times_ms(render, scene, FrameState.initial(),
                                            frames=FRAMES)
    shadow_rays = int(aux["shadow_rays"])
    return percentile(samples, 50), percentile(samples, 95), shadow_rays


def measure_baseline(scene, meta):
    """Run the C++ CPU oracle on the same scene/resolution; cache the result."""
    if BASELINE_CACHE.exists():
        try:
            cached = json.loads(BASELINE_CACHE.read_text())
            if cached.get("width") == W and cached.get("height") == H:
                return cached
        except (ValueError, KeyError):
            pass
    binary = REPO / "native" / "cpu_reference"
    if not binary.exists():
        subprocess.run(["make", "-C", str(REPO / "native")], check=True,
                       capture_output=True)
    from relativitypathtracer_tpu.render import FrameState
    from relativitypathtracer_tpu.utils.scene_blob import write_scene_blob

    blob = "/tmp/bench_baseline.blob"
    write_scene_blob(blob, scene, meta, FrameState.initial(), W, H)
    out = subprocess.run(
        [str(binary), blob, "/tmp/bench_baseline.rgb", "3"],
        check=True, capture_output=True, text=True,
    )
    stats = json.loads(out.stdout.strip().splitlines()[-1])
    stats["note"] = "C++ CPU oracle (reference algorithm), this host"
    BASELINE_CACHE.write_text(json.dumps(stats, indent=1))
    return stats


_START = time.time()


def main():
    # 25 min covers the worst case (first-run large-mesh build); a wedge
    # past that emits an error JSON instead of nothing.
    wd = _watchdog(1500)

    import jax

    # Smoke-test hook: CPU smoke runs of the bench flow pin the platform via
    # jax.config (before first backend use). Unset for official runs.
    if os.environ.get("RPT_PLATFORM"):
        jax.config.update("jax_platforms", os.environ["RPT_PLATFORM"])

    if cpu_fallback(jax.default_backend(), os.environ.get("RPT_PLATFORM")):
        wd.cancel()
        print(json.dumps({
            "metric": f"total Mrays/s, bunny.txt {W}x{H} (primary+shadow), p50",
            "value": 0.0, "unit": "Mrays/s", "vs_baseline": 0.0,
            "platform": "cpu",
            "error": "official run fell back to the CPU backend; "
                     "refusing to record CPU frames as an accelerator "
                     "artifact",
        }), flush=True)
        sys.exit(4)

    if os.environ.get("RPT_POST_DIAG", "").strip():
        # The post-pipeline diagnostic stubs render WRONG images (see
        # render._post_diag); a leaked env var must never shape an official
        # headline or parity section.
        wd.cancel()
        print(json.dumps({
            "metric": f"total Mrays/s, bunny.txt {W}x{H} (primary+shadow), p50",
            "value": 0.0, "unit": "Mrays/s", "vs_baseline": 0.0,
            "error": "RPT_POST_DIAG is set (diagnostic stub renders); "
                     "refusing to record as an official artifact",
        }), flush=True)
        sys.exit(5)

    from relativitypathtracer_tpu import __version__, build_scene, load_scene_file
    from relativitypathtracer_tpu.utils.jaxcache import enable as _enable_cache

    _enable_cache()  # share compiles with the other entry points

    scene_path = REF / "Scenes" / "bunny.txt"
    log(f"loading {scene_path}")
    host = load_scene_file(str(scene_path))
    scene, meta = build_scene(host)

    log("measuring baseline (C++ CPU oracle)...")
    base = measure_baseline(scene, meta)
    base_rays = W * H + base["shadow_rays"]
    base_mrays = base_rays / (base["p50_ms"] * 1e3)
    log(f"baseline: {base['p50_ms']:.1f} ms/frame, {base_mrays:.2f} Mrays/s "
        f"({base['threads']} thread(s))")

    log(f"measuring the renderer ({jax.default_backend()})...")
    p50, p95, shadow_rays = measure_ours(scene, meta)
    rays = W * H + shadow_rays
    mrays = rays / (p50 * 1e3)
    log(f"ours: {p50:.2f} ms/frame p50, {p95:.2f} p95 over {FRAMES} "
        f"frames, {mrays:.2f} Mrays/s ({shadow_rays} shadow rays)")
    PARTIAL.update({
        "resolution": f"{W}x{H}",
        "value": round(mrays, 3),
        "vs_baseline": round(mrays / base_mrays, 3),
        "frame_ms_p50": round(p50, 3),
        "frame_ms_p95": round(p95, 3),
        "frames_timed": FRAMES,
        "baseline_frame_ms_p50": base["p50_ms"],
        "baseline_mrays": round(base_mrays, 3),
        "platform": jax.default_backend(),
        "device_kind": jax.devices()[0].device_kind,
        "version": __version__,
    })

    # Per-scene frame times: arch + cubes (the large-texture scenes) and
    # MSAA scaling on bunny. Each entry is a p50 over 36 frames through the
    # already-warm process; budget-guarded so a slow run degrades to missing
    # entries, not a wedge.
    frametimes = {}
    PARTIAL["scene_frametimes_ms"] = frametimes  # mutated in place below
    ft_deadline = _START + 1500 - 600  # parity + large-mesh need the rest
    for ft_scene, ft_msaa in (("arch", 1), ("cubes", 1), ("bunny", 2),
                              ("bunny", 4)):
        key = ft_scene if ft_msaa == 1 else f"{ft_scene}_msaa{ft_msaa}"
        if time.time() > ft_deadline:
            frametimes[key] = "skipped (watchdog budget)"
            continue
        try:
            from relativitypathtracer_tpu.render import (
                FrameState as _FS,
                build_render_fn,
            )
            from relativitypathtracer_tpu.utils.timing import (
                frame_times_ms, percentile)

            host_ft = load_scene_file(str(REF / "Scenes" / f"{ft_scene}.txt"))
            sc_ft, meta_ft = build_scene(host_ft)
            render_ft = build_render_fn(meta_ft, W, H, meta_ft.default_interval,
                                        ft_msaa)
            best = percentile(frame_times_ms(render_ft, sc_ft, _FS.initial(),
                                             frames=36)[0], 50)
            frametimes[key] = round(best, 3)
            log(f"frametime {key}: {best:.2f} ms")
        except Exception as e:  # noqa: BLE001
            log(f"frametime {key} errored: {e}")
            frametimes[key] = f"error: {str(e)[:80]}"

    # Full-resolution oracle parity (README's >99.8%-within-1e-3 claim) on
    # ALL 8 reference scenes, enforced on the real backend every round, plus
    # one boosted / advanced-time state (the full per-frame boost chain at
    # production resolution) -- the scene-gallery contract
    # (/root/reference/README.md:77-124) as a driver-visible artifact.
    # Failures degrade to an error field rather than losing the benchmark
    # line; if the run approaches the watchdog, remaining scenes are marked
    # skipped instead of silently dropped.
    from relativitypathtracer_tpu.render import FrameState
    from relativitypathtracer_tpu.utils.parity import fullres_parity

    import jax.numpy as jnp

    boosted = FrameState(
        cam_velocity=jnp.array([0.3, 0.1, -0.2], jnp.float32),
        cam_pos=jnp.array([2.5, 0, 0, 0], jnp.float32),
    )
    cases = [("bunny", "bunny", None), ("shadows", "shadows", None),
             ("rulers", "rulers_boosted", boosted)]
    cases += [(s, s, None) for s in
              ("arch", "cube", "cubes", "ladder_paradox", "rulers", "soccer")]
    parity = {}
    PARTIAL["fullres_parity_frac_gt_1e3"] = parity  # mutated in place below
    parity_deadline = _START + 1500 - 240  # leave the large-mesh tier room
    for scene_name, tag, state in cases:
        if time.time() > parity_deadline:
            parity[f"{tag}_skipped"] = "watchdog budget"
            continue
        try:
            res = fullres_parity(scene_name, W, H, state=state, tag=tag)
        except Exception as e:  # noqa: BLE001
            log(f"full-res parity {tag} errored: {e}")
            parity[f"{tag}_error"] = str(e)[:120]
            continue
        log(f"full-res parity {tag}: frac>1e-3 = {res['frac_bad']:.5f} "
            f"(ok={res['ok']})")
        parity[tag] = res["frac_bad"]
        parity[f"{tag}_ok"] = res["ok"]

    # Large-mesh capability: the flagship mesh subdivided to 327,680 tris
    # (utils.largedemo) through the Triton walk, full-res oracle parity +
    # frame time.
    large = {}
    try:
        from relativitypathtracer_tpu.utils.largedemo import large_parity_and_time

        large = large_parity_and_time(W, H)
        log(f"large mesh ({large['tris']} tris): {large['frame_ms']:.1f} ms/frame, "
            f"frac>1e-3 = {large['frac_bad']:.5f} (ok={large['ok']})")
    except Exception as e:  # noqa: BLE001
        import traceback
        traceback.print_exc(file=sys.stderr)
        large = {"error": str(e)[:120]}
    PARTIAL["large_mesh"] = large

    line = {
        "metric": f"total Mrays/s, bunny.txt {W}x{H} (primary+shadow), p50",
        "unit": "Mrays/s",
    }
    line.update(PARTIAL)
    print(json.dumps(line))
    wd.cancel()


if __name__ == "__main__":
    main()
