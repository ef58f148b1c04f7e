"""Round-robin stage profiler: times the frame's sub-pipelines interleaved
over several rounds, so clock and power drift affect every stage equally.
Each sample is a wall time ended by block_until_ready (utils/timing.py).
Usage: python tools/profile_frame.py [scene] [WxH] [rounds]

scene: "flagship" (default, utils.demo_scenes) or the name of a reference
scene under $REF_ASSETS/Scenes.
"""

from __future__ import annotations

import os
import pathlib
import sys

import numpy as np

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
REF = pathlib.Path(os.environ.get("REF_ASSETS", "/root/reference"))

if __name__ == "__main__":
    import jax
    import jax.numpy as jnp

    from relativitypathtracer_tpu import build_scene, load_scene_file
    from relativitypathtracer_tpu.ops.camera import camera_ray_dirs
    from relativitypathtracer_tpu.ops.intersect import (
        apply_affine3, apply_linear3, norm3, normalize3,
    )
    from relativitypathtracer_tpu.ops.mesh_intersect import (
        mesh_intersect_shared, mesh_min_t_general,
    )
    from relativitypathtracer_tpu.ops.pallas.mesh_kernels import NB, live_chunk_lists
    from relativitypathtracer_tpu.render import (
        FrameState, TILE, _round_up, build_render_fn, gather_mats, hit_events,
        intersect_scene, light_rays, object_frames, scene_min_t, tile_swizzle,
    )
    from relativitypathtracer_tpu.utils.demo_scenes import flagship_scene
    from relativitypathtracer_tpu.utils.timing import frame_times_ms

    name = sys.argv[1] if len(sys.argv) > 1 else "flagship"
    size = sys.argv[2] if len(sys.argv) > 2 else "1024x768"
    rounds = int(sys.argv[3]) if len(sys.argv) > 3 else 5
    W, H = (int(x) for x in size.split("x"))
    if name == "flagship":
        scene, meta = flagship_scene()
    else:
        scene, meta = build_scene(load_scene_file(str(REF / "Scenes" / f"{name}.txt")))
    state = FrameState.initial()
    interval = meta.default_interval
    print(f"scene={name} {W}x{H} device={jax.devices()[0].device_kind} "
          f"rounds={rounds}", file=sys.stderr)

    ph, pw = _round_up(H, TILE), _round_up(W, TILE)
    dirs = camera_ray_dirs(W, H, pad_width=pw, pad_height=ph)
    dirs_t = jax.device_put(tile_swizzle(dirs.reshape(-1, 3).T, ph, pw))
    n = dirs_t.shape[1]
    n_pad = _round_up(n, NB)

    stages = {}

    full = build_render_fn(meta, W, H, interval, 1)
    stages["full frame"] = (full, (scene, state))

    @jax.jit
    def frame_parts(scene, state, d):
        with jax.default_matmul_precision("highest"):
            L, inv_L, stat_cam = object_frames(scene.objects, state)
            dir4 = jnp.concatenate([jnp.full((1, n), float(interval)), d], axis=0)
            t, normal, uv, obj, did_hit = intersect_scene(
                scene, meta, L, stat_cam, dir4, interval)
            return L, inv_L, stat_cam, dir4, t, normal, obj, did_hit

    L, inv_L, stat_cam, dir4, t, normal, obj, did_hit = frame_parts(scene, state, dirs_t)
    stages["primary all-objects"] = (frame_parts, (scene, state, dirs_t))

    if meta.mesh_ids:
        k, mi = 0, meta.mesh_ids[0]
        perm = jnp.asarray(meta.mesh_perms[k], jnp.int32) if meta.mesh_perms[k] else None
        rng_k = meta.mesh_tri_ranges[k]
        static = scene.mesh_static[k]

        @jax.jit
        def primary_mesh(scene, L, stat_cam, dir4):
            with jax.default_matmul_precision("highest"):
                d4 = L[mi] @ dir4
                return mesh_intersect_shared(
                    scene.mesh, rng_k, scene.objects.m[mi], scene.objects.inv_m[mi],
                    stat_cam[mi, 1:4], d4[1:4], perm=perm, static=static)

        stages["primary mesh (incl list)"] = (primary_mesh, (scene, L, stat_cam, dir4))

        @jax.jit
        def primary_list(scene, L, stat_cam, dir4):
            with jax.default_matmul_precision("highest"):
                d4 = L[mi] @ dir4
                ro = apply_affine3(scene.objects.inv_m[mi], stat_cam[mi, 1:4])
                dd = apply_linear3(scene.objects.inv_m[mi], d4[1:4])
                dh = dd / norm3(dd)
                dh_p = jnp.pad(dh, ((0, 0), (0, n_pad - n)), constant_values=1.0)
                ro_p = jnp.broadcast_to(ro[:, None], (3, n_pad))
                return live_chunk_lists(static.spheres, dh_p, ro_p)

        stages["primary live list"] = (primary_list, (scene, L, stat_cam, dir4))

    if meta.light_ids and interval != 0:
        li = meta.light_ids[0]

        @jax.jit
        def shadow_setup(scene, L, inv_L, stat_cam, dir4, t, normal, obj, did_hit):
            with jax.default_matmul_precision("highest"):
                onehot = (jnp.arange(meta.num_objects)[:, None] == obj[None, :]
                          ).astype(jnp.float32)
                L_hit = gather_mats(L, onehot)
                hit_pos = hit_events(inv_L, onehot, L_hit, stat_cam.T @ onehot,
                                     dir4, t, normal, did_hit)
                ld3, _, ndotl, tmax = light_rays(scene.objects, L, inv_L, L_hit,
                                                 hit_pos, normal, interval, li)
                relevant = did_hit & (obj != li) & (ndotl > 0)
                return hit_pos, ld3, jnp.where(relevant, tmax, 0.0)

        setup_args = (scene, L, inv_L, stat_cam, dir4, t, normal, obj, did_hit)
        stages["shadow setup"] = (shadow_setup, setup_args)
        hit_pos, ld3, tmax_m = shadow_setup(*setup_args)
        sdir4 = jnp.concatenate(
            [jnp.full((1, n), float(interval)), normalize3(ld3)], axis=0)

        if meta.mesh_ids:
            @jax.jit
            def shadow_mesh(scene, hit_pos, sdir4, tmax_m):
                with jax.default_matmul_precision("highest"):
                    o4 = L[mi] @ hit_pos
                    d4 = L[mi] @ sdir4
                    return mesh_min_t_general(
                        scene.mesh, rng_k, scene.objects.m[mi],
                        scene.objects.inv_m[mi], o4[1:4], d4[1:4], perm=perm,
                        tmax=tmax_m, static=static)

            stages["shadow mesh (incl list)"] = (shadow_mesh, (scene, hit_pos, sdir4, tmax_m))

            @jax.jit
            def shadow_list(scene, hit_pos, sdir4, tmax_m):
                with jax.default_matmul_precision("highest"):
                    o4 = L[mi] @ hit_pos
                    d4 = L[mi] @ sdir4
                    ro = apply_affine3(scene.objects.inv_m[mi], o4[1:4])
                    dd = apply_linear3(scene.objects.inv_m[mi], d4[1:4])
                    dh = dd / norm3(dd)
                    dh_p = jnp.pad(dh, ((0, 0), (0, n_pad - n)), constant_values=1.0)
                    ro_p = jnp.pad(ro, ((0, 0), (0, n_pad - n)))
                    valid_p = jnp.pad(tmax_m > 0, (0, n_pad - n))
                    return live_chunk_lists(static.spheres, dh_p, ro_p, valid=valid_p)

            stages["shadow live list"] = (shadow_list, (scene, hit_pos, sdir4, tmax_m))

        @jax.jit
        def shadow_all(scene, hit_pos, ld3, tmax_m):
            with jax.default_matmul_precision("highest"):
                return scene_min_t(scene, meta, L, hit_pos, ld3, interval, li,
                                   tmax=tmax_m)

        stages["shadow all-objects"] = (shadow_all, (scene, hit_pos, ld3, tmax_m))

    times = {k: [] for k in stages}
    for _r in range(rounds):
        for key, (fn, args) in stages.items():
            times[key] += frame_times_ms(fn, *args, frames=10)[0]

    for key, vals in times.items():
        v = np.asarray(vals)
        print(f"{key:28s} min={v.min():7.3f}  med={np.median(v):7.3f} ms")
