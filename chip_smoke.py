"""Smoke test of the renderer on one NVIDIA GPU: the flagship frame end to end.

    python chip_smoke.py [--seed N] [--frames N]
    python chip_smoke.py --four-cards      # the sharded path on four GPUs only

Phases (any failure exits non-zero; the last stdout line is one JSON object
only when every phase passed):

1. device   -- JAX must run on a GPU; prints device_kind, the device count
               and the card's name and power limit from nvidia-smi.
2. frame    -- builds the flagship scene (utils.demo_scenes) and renders one
               1024x768 frame through build_render_fn (Triton mesh walks);
               prints the compile seconds.
3. kernels  -- the Triton walks against the jnp scan on the card, on that
               frame's primary and shadow rays: winning triangle ids, shadow
               hit/miss and occlusion verdicts equal on >= 99.9% of lanes;
               primary t within 1e-5 relative on >= 99.9% of the lanes both
               hit, shadow t on >= 99.5% (grazing hits, see
               SHADOW_T_AGREE and compare_walks); both
               whole-frame times (p50 over --frames frames).
4. oracle   -- the GPU frame against the C++ oracle (native/cpu_reference,
               built with make): frac_bad <= utils.parity.MAX_FRAC_BAD.
5. timing   -- p50/p95 ms and Mrays/s (primary + shadow rays) over --frames
               frames, beside the card's name and power limit.

--four-cards runs only the sharded path: parallel.tiles over a 1-D mesh of
four GPUs, compared with the single-card frame.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np

W, H = 1024, 768
AGREE = 0.999  # share of lanes on which kernel and scan must agree
# Share of shadow hits whose t must agree within T_RTOL: ~0.3% of the
# flagship's shadow hits graze the surface, where the Plucker form of t is
# ill-conditioned and BOTH f32 routes sit ~6e-5 from a float64 evaluation.
SHADOW_T_AGREE = 0.995
T_RTOL = 1e-5  # relative t difference that counts as agreement
SELF_BAND = 0.01  # shadow hits this near their origin are surface noise


class SmokeFailure(RuntimeError):
    pass


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise SmokeFailure(msg)


def check_devices(devices) -> None:
    """Phase 1's rule: every device JAX found must be a GPU."""
    check(len(devices) > 0, "JAX found no device")
    bad = sorted({d.platform for d in devices if d.platform != "gpu"})
    check(not bad, f"JAX found no GPU (platforms: {', '.join(bad)})")


def card_line() -> str:
    """`name, power.limit` of the first card, read outside JAX."""
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    check(res.returncode == 0 and res.stdout.strip(), "nvidia-smi failed")
    return res.stdout.strip().splitlines()[0]


def phase(name: str):
    print(f"== {name}", flush=True)


def p50_p95(times):
    from relativitypathtracer_tpu.utils.timing import percentile

    return percentile(times, 50), percentile(times, 95)


def compiled_frame(meta, kernels: bool, scene, state, **kw):
    """The build_render_fn frame with the mesh walks forced to the Triton
    kernels (True) or the jnp scan (False), traced and compiled while the
    route is forced. Returns (executable, compile seconds)."""
    from relativitypathtracer_tpu.ops import mesh_intersect
    from relativitypathtracer_tpu.render import build_render_fn

    mesh_intersect.PALLAS_MODE = kernels
    build_render_fn.cache_clear()
    try:
        t0 = time.perf_counter()
        fn = build_render_fn(meta, W, H, meta.default_interval, **kw)
        exe = fn.lower(scene, state).compile()
        return exe, time.perf_counter() - t0
    finally:
        mesh_intersect.PALLAS_MODE = None
        build_render_fn.cache_clear()


def compare_walks(scene, meta, state):
    """Kernel vs scan on the frame's own primary and shadow rays."""
    import functools

    import jax
    import jax.numpy as jnp

    from relativitypathtracer_tpu.ops import mesh_intersect
    from relativitypathtracer_tpu.ops.camera import camera_ray_dirs
    from relativitypathtracer_tpu.render import (
        TILE, _round_up, gather_mats, hit_events, intersect_scene,
        light_rays, object_frames, scene_min_t, tile_swizzle)

    ph, pw = _round_up(H, TILE), _round_up(W, TILE)
    dirs = tile_swizzle(camera_ray_dirs(W, H, 1, pad_width=pw,
                                        pad_height=ph).reshape(-1, 3).T, ph, pw)
    interval = meta.default_interval
    dir4 = jnp.concatenate([jnp.full((1, dirs.shape[1]), float(interval)), dirs])
    k, i_mesh, i_light = 0, meta.mesh_ids[0], meta.light_ids[0]
    perm = jnp.asarray(meta.mesh_perms[k], jnp.int32)

    def routed(fn, kernels):
        """jit fn with the mesh walks forced to one route at trace time."""
        @functools.wraps(fn)
        def traced(*a):
            mesh_intersect.PALLAS_MODE = kernels
            try:
                with jax.default_matmul_precision("highest"):
                    return fn(*a)
            finally:
                mesh_intersect.PALLAS_MODE = None
        return jax.jit(traced)

    def primary(scene, state):
        L, _, stat_cam = object_frames(scene.objects, state)
        d4 = L[i_mesh] @ dir4
        _, _, bt, _, _, btri = mesh_intersect.mesh_nearest_hit(
            scene.mesh, meta.mesh_tri_ranges[k], scene.objects.inv_m[i_mesh],
            stat_cam[i_mesh, 1:4], d4[1:4], perm=perm,
            static=scene.mesh_static[k])
        return bt, btri

    def shadow_rays(scene, state):
        L, inv_L, stat_cam = object_frames(scene.objects, state)
        t, normal, _, obj, did_hit = intersect_scene(scene, meta, L, stat_cam,
                                                     dir4, interval)
        onehot = (jnp.arange(meta.num_objects)[:, None] == obj[None, :]
                  ).astype(jnp.float32)
        L_hit = gather_mats(L, onehot)
        hit_pos = hit_events(inv_L, onehot, L_hit, stat_cam.T @ onehot, dir4,
                             t, normal, did_hit)
        ld3, _, ndotl, tmax = light_rays(scene.objects, L, inv_L, L_hit,
                                         hit_pos, normal, interval, i_light)
        relevant = did_hit & (obj != i_light) & (ndotl > 0)
        return hit_pos, ld3, jnp.where(relevant, tmax, 0.0), relevant

    def occlusion(scene, state, hit_pos, ld3, tmax):
        L = object_frames(scene.objects, state)[0]
        exact = scene_min_t(scene, meta, L, hit_pos, ld3, interval, i_light)
        bounded = scene_min_t(scene, meta, L, hit_pos, ld3, interval, i_light,
                              tmax=tmax)
        return exact, bounded

    bt_k, tri_k = routed(primary, True)(scene, state)
    bt_s, tri_s = routed(primary, False)(scene, state)
    hit_pos, ld3, tmax, relevant = routed(shadow_rays, True)(scene, state)
    ex_k, bd_k = routed(occlusion, True)(scene, state, hit_pos, ld3, tmax)
    ex_s, bd_s = routed(occlusion, False)(scene, state, hit_pos, ld3, tmax)

    bt_k, tri_k, bt_s, tri_s = map(np.asarray, (bt_k, tri_k, bt_s, tri_s))
    hit_k, hit_s = bt_k < 1e19, bt_s < 1e19
    both = hit_k & hit_s
    # Lanes either route hits must agree on the winning triangle.
    tri_agree = float(np.mean((tri_k == tri_s)[hit_k | hit_s] & both[hit_k | hit_s]))
    t_rel = np.abs(bt_k[both] - bt_s[both]) / bt_s[both]
    rel = np.asarray(relevant)
    ex_k, ex_s, bd_k, bd_s, tm = (np.asarray(x)[rel]
                                  for x in (ex_k, ex_s, bd_k, bd_s, tmax))
    # Shadow rays start on a surface (0.001 off it along the shading
    # normal): whether a facet at t ~ 0 is accepted is fp noise in either
    # route, so lanes where either route hits within SELF_BAND are left out
    # of the t comparison (counted), and below t = 1 t is compared
    # absolutely (a nearby facet's t is a difference of large terms).
    sh_both = (ex_k < 1e19) & (ex_s < 1e19)
    near = sh_both & (np.minimum(ex_k, ex_s) < SELF_BAND)
    far = sh_both & ~near
    sh_rel = np.abs(ex_k[far] - ex_s[far]) / np.maximum(ex_s[far], 1.0)
    worst = np.argsort(-sh_rel)[:4]
    return {
        "primary_rays": int(bt_k.size), "primary_hits": int(hit_s.sum()),
        "tri_agree": tri_agree, "t_agree": float(np.mean(t_rel <= T_RTOL)),
        "t_max_rel": float(t_rel.max()),
        "shadow_rays": int(rel.sum()),
        "shadow_hit_agree": float(np.mean((ex_k < 1e19) == (ex_s < 1e19))),
        "shadow_self_band": int(near.sum()),
        "shadow_t_agree": float(np.mean(sh_rel <= T_RTOL)),
        "shadow_t_max_rel": float(sh_rel.max()),
        "shadow_worst_t": [[float(ex_k[far][w]), float(ex_s[far][w])] for w in worst],
        # the renderer's question: is the light occluded (t < tmax)?
        "shadow_verdict_agree": float(np.mean((bd_k < tm) == (bd_s < tm))),
    }


def single_card(args, card: str):
    import jax

    from relativitypathtracer_tpu.render import FrameState
    from relativitypathtracer_tpu.utils.demo_scenes import flagship_scene
    from relativitypathtracer_tpu.utils.parity import MAX_FRAC_BAD, _ensure_oracle
    from relativitypathtracer_tpu.utils.scene_blob import write_scene_blob
    from relativitypathtracer_tpu.utils.timing import frame_times_ms

    phase("frame: flagship scene, 1024x768, Triton mesh walks")
    t0 = time.perf_counter()
    scene, meta = flagship_scene(args.seed)
    print(f"scene build {time.perf_counter() - t0:.1f} s: {meta.num_tris} tris, "
          f"{meta.num_objects} objects, interval {meta.default_interval}", flush=True)
    state = FrameState.initial()
    render, compile_s = compiled_frame(meta, True, scene, state, with_aux=True)
    times_k, _, (img, aux) = frame_times_ms(render, scene, state,
                                            frames=args.frames)
    img = np.asarray(img)
    check(img.shape == (H, W, 3), f"frame shape {img.shape}")
    check(bool(np.isfinite(img).all()), "non-finite pixels")
    hits, shadow = int(aux["hits"]), int(aux["shadow_rays"])
    check(hits > 0.05 * W * H, f"only {hits} primary hits")
    print(f"compile {compile_s:.1f} s; hits {hits}; shadow rays {shadow}", flush=True)

    phase("kernels: Triton walks vs jnp scan on the card")
    cmp = compare_walks(scene, meta, state)
    print(json.dumps(cmp), flush=True)
    for key in ("tri_agree", "t_agree", "shadow_hit_agree",
                "shadow_verdict_agree"):
        check(cmp[key] >= AGREE, f"{key} {cmp[key]} < {AGREE}")
    check(cmp["shadow_t_agree"] >= SHADOW_T_AGREE,
          f"shadow_t_agree {cmp['shadow_t_agree']} < {SHADOW_T_AGREE}")
    render_s, compile_scan = compiled_frame(meta, False, scene, state,
                                            with_aux=True)
    times_s, _, _ = frame_times_ms(render_s, scene, state, frames=args.frames)
    k50, s50 = p50_p95(times_k)[0], p50_p95(times_s)[0]
    print(f"frame p50 over {args.frames}: Triton walks {k50:.3f} ms, jnp scan "
          f"{s50:.3f} ms (scan compile {compile_scan:.1f} s) [{card}]", flush=True)

    phase("oracle: GPU frame vs native/cpu_reference")
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        blob, out = f"{tmp}/flagship.blob", f"{tmp}/flagship.rgb"
        write_scene_blob(blob, scene, meta, state, W, H)
        t0 = time.perf_counter()
        subprocess.run([_ensure_oracle(), blob, out], check=True,
                       capture_output=True)
        oracle_s = time.perf_counter() - t0
        ref = np.fromfile(out, np.float32).reshape(H, W, 3)
    diff = np.abs(ref - img)
    frac_bad = float(np.mean(diff.max(-1) > 1e-3))
    print(f"frac_bad {frac_bad:.6f} (limit {MAX_FRAC_BAD}), mean diff "
          f"{float(diff.mean()):.2e}, oracle {oracle_s:.1f} s", flush=True)
    check(frac_bad <= MAX_FRAC_BAD, f"oracle parity frac_bad {frac_bad}")

    phase("timing: Triton route, whole frame")
    times, _, _ = frame_times_ms(render, scene, state, frames=max(args.frames, 100))
    p50, p95 = p50_p95(times)
    mrays = (W * H + shadow) / (p50 * 1e-3) / 1e6
    print(f"p50 {p50:.3f} ms, p95 {p95:.3f} ms over {len(times)} frames, "
          f"{mrays:.2f} Mrays/s ({W * H} primary + {shadow} shadow rays) "
          f"[{card}] [{jax.devices()[0].device_kind}]", flush=True)


def four_cards(args, card: str):
    import jax

    from relativitypathtracer_tpu.parallel.tiles import (
        build_sharded_render_fn, default_mesh)
    from relativitypathtracer_tpu.render import FrameState
    from relativitypathtracer_tpu.utils.demo_scenes import flagship_scene
    from relativitypathtracer_tpu.utils.timing import frame_times_ms

    phase("four cards: sharded flagship frame vs single card")
    check(len(jax.devices()) == 4, f"need 4 GPUs, found {len(jax.devices())}")
    scene, meta = flagship_scene(args.seed)
    state = FrameState.initial()
    render1, compile1 = compiled_frame(meta, True, scene, state)
    single, _, ref = frame_times_ms(render1, scene, state, frames=args.frames)
    mesh = default_mesh(4)
    render = build_sharded_render_fn(meta, W, H, meta.default_interval, mesh)
    sharded, compile4, img = frame_times_ms(render, scene, state,
                                            frames=args.frames)
    diff = np.abs(np.asarray(img) - np.asarray(ref))
    frac_bad = float(np.mean(diff.max(-1) > 1e-3))
    print(f"compile 1 card {compile1:.1f} s, 4 cards {compile4:.1f} s; "
          f"vs single card: max diff {float(diff.max()):.2e}, frac_bad "
          f"{frac_bad:.6f}", flush=True)
    check(bool(np.isfinite(np.asarray(img)).all()), "non-finite pixels")
    check(frac_bad <= 0.002 and float(diff.mean()) < 1e-4,
          "sharded frame differs from the single-card frame")
    print(f"p50 1 card {p50_p95(single)[0]:.3f} ms, 4 cards "
          f"{p50_p95(sharded)[0]:.3f} ms over {args.frames} frames [{card} x4]",
          flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--frames", type=int, default=50)
    ap.add_argument("--four-cards", action="store_true")
    args = ap.parse_args(argv)

    import jax

    try:
        from relativitypathtracer_tpu.utils.jaxcache import enable

        phase("device")
        devices = jax.devices()
        check_devices(devices)
        card = card_line()
        print(f"platform {devices[0].platform}, device_kind "
              f"{devices[0].device_kind}, count {len(devices)}", flush=True)
        print(card, flush=True)
        enable()
        (four_cards if args.four_cards else single_card)(args, card)
    except Exception as exc:  # every phase failure ends the run non-zero
        print(f"FAILED: {type(exc).__name__}: {exc}", file=sys.stderr, flush=True)
        return 1
    d = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
