"""raytracingc_tpu — a differentiable Monte-Carlo path tracer in JAX.

A path tracer with the same capabilities as the reference CPU renderer
``Atsuyo64/RayTracingC`` (a Sebastian-Lague-style path tracer written in C),
running on an NVIDIA GPU (or the CPU):

* OBJ/MTL and ``triangles.txt`` scene ingest (reference ``objloader.c``,
  ``raytracing.c:19-147``), here parsed into structure-of-arrays JAX pytrees.
* Möller–Trumbore ray–triangle and quadratic ray–sphere intersection
  (reference ``raytracing.c:162-240``), here a closest-hit search (a fused
  Pallas kernel on the GPU, an XLA scan on the CPU) plus a differentiable
  refinement pass.
* Lambertian/specular path-traced shading with emissive materials, Russian
  roulette, and a procedural sky/sun environment (reference
  ``raytracing.c:151-296``), here fused XLA ops under ``jax.lax.scan``.
* Multi-sample accumulation and BMP/PNG writeback (reference ``main.c:98-100,305``).
* Scaling over device meshes via ``jax.sharding`` + ``shard_map``: image/sample
  axes sharded per device, scene buffers replicated or block-sharded, radiance
  and scene-parameter gradients ``psum``-reduced (the reference's 12-pthread
  row-cyclic executor, ``main.c:81-105,284-303``).
* End-to-end differentiability: gradients of pixel values w.r.t. vertex
  positions, normals, albedo, emission, and environment parameters — something
  the reference does not have at all.

Everything is float32 and statically shaped; divergent control flow from the C
integrator (early breaks, roulette) is expressed as masked dataflow.
"""

__version__ = "0.1.0"

from raytracingc_tpu.scene.types import (  # noqa: F401
    Triangles,
    Spheres,
    EnvParams,
    Scene,
)
from raytracingc_tpu.camera import Camera, look_at_basis, primary_rays  # noqa: F401
from raytracingc_tpu.render.renderer import render, render_image  # noqa: F401
from raytracingc_tpu.render.progressive import render_progressive  # noqa: F401
from raytracingc_tpu.scene.builder import (  # noqa: F401
    scene_from_obj,
    scene_from_triangles_txt,
)


def __getattr__(name):  # lazy: these pull in optax/mesh machinery
    if name == "fit_scene":
        from raytracingc_tpu.diff.optimize import fit_scene

        return fit_scene
    if name == "render_sharded":
        from raytracingc_tpu.parallel.sharded import render_sharded

        return render_sharded
    if name == "make_mesh":
        from raytracingc_tpu.parallel.mesh import make_mesh

        return make_mesh
    raise AttributeError(name)
