"""Convex-polygons synthetic dataset (the port's copy of
compare_gan_tpu/polygons.py): "Are GANs Created Equal?", NeurIPS 2018;
reference colabs/Convex_Polygons_Dataset.ipynb.

Random convex polygons, rasterized dark-on-light with subpixel
antialiasing. The paper's datasets are 80k instances of 28x28 triangles
(60k train / 10k test / 10k holdout).

Construction (same geometry as the reference generator): the circle is
split into `n_vertices` angular segments; one vertex is drawn per segment
with a `min_segment_angle/2` margin at each boundary, so neighboring
vertices are at least `min_segment_angle` degrees apart. Vertices land on
a circle of diameter `scale * raster_dim`, randomly rotated. Each pixel's
value is the fraction of its `subpixel_res`^2 subpixel centers OUTSIDE
the polygon (background 1.0, interior 0.0).

Intentional deviations from the notebook (documented, behavior-level):
* rotation is uniform over the full circle (the notebook converts an
  already-radian angle with `np.radians` again, limiting rotation to
  ~6 degrees) and applied to the vertex angles, keeping the polygon
  centered instead of rotating the unit square about its corner;
* antialiasing averages each pixel's own subpixel block (the notebook's
  corner-anchored convolution window samples a half-pixel-shifted
  neighborhood).

`generate_dataset` matches the notebook's surface (labels = n_vertices,
shuffled); `write_npz_dataset` emits `<dir>/convex_polygons/{split}.npz`
in this framework's on-disk layout so the `convex_polygons` registry
entry can train on it.
"""

from __future__ import annotations

import os

import numpy as np


def _draw_vertex_angles(rng: np.random.RandomState, n_vertices: int,
                        min_segment_angle: float) -> np.ndarray:
    """The ONLY rng consumption of one polygon: its vertex angles (rad).

    Kept as a separate step so dataset writers can thread the sequential
    RandomState through all instances cheaply and hand the expensive
    rasterization to worker threads — the parallel path consumes the
    stream identically, so its output is bit-identical to the serial one
    (asserted in tests/test_polygons.py for the JAX package's copy)."""
    segment = 360.0 / n_vertices
    # Per-segment vertex angle with half-margins at both segment ends.
    offsets = rng.rand(n_vertices) * (segment - min_segment_angle)
    angles = (np.arange(n_vertices) * segment + min_segment_angle / 2.0
              + offsets)
    return np.radians(angles + rng.rand() * 360.0)  # Random rotation.


def _rasterize_polygon(angles: np.ndarray, scale: float, raster_dim: int,
                       subpixel_res: int,
                       shift_to_mean: bool = False) -> np.ndarray:
    """Rasterize pre-drawn vertex angles (rng-free, thread-parallel
    safe): one [raster_dim, raster_dim] float32 image in [0, 1]."""
    center = raster_dim / 2.0
    radius = scale * raster_dim / 2.0
    vx = center + radius * np.cos(angles)
    vy = center + radius * np.sin(angles)
    if shift_to_mean:
        vx += center - vx.mean()
        vy += center - vy.mean()

    # Subpixel centers in raster units.
    r = subpixel_res
    coords = (np.arange(raster_dim * r) + 0.5) / r
    px, py = np.meshgrid(coords, coords, indexing="ij")

    # Convex polygon containment: vertices are in CCW angular order, so a
    # point is inside iff it is left of (or on) every directed edge.
    inside = np.ones(px.shape, dtype=bool)
    for k in range(len(vx)):
        ax, ay = vx[k], vy[k]
        bx, by = vx[(k + 1) % len(vx)], vy[(k + 1) % len(vy)]
        cross = (bx - ax) * (py - ay) - (by - ay) * (px - ax)
        inside &= cross >= 0.0
    outside = (~inside).astype(np.float32)

    # Box-average each pixel's r x r subpixel block.
    blocks = outside.reshape(raster_dim, r, raster_dim, r)
    return blocks.mean(axis=(1, 3))


def generate_convex_polygon(rng: np.random.RandomState, n_vertices: int,
                            min_segment_angle: float, scale: float,
                            raster_dim: int, subpixel_res: int,
                            shift_to_mean: bool = False) -> np.ndarray:
    """One [raster_dim, raster_dim] float32 image in [0, 1]."""
    angles = _draw_vertex_angles(rng, n_vertices, min_segment_angle)
    return _rasterize_polygon(angles, scale, raster_dim, subpixel_res,
                              shift_to_mean)


def _rasterize_all(per_image_angles, scale, raster_dim, subpixel_res,
                   shift_to_mean=False, n_workers=0):
    """Rasterize a list of pre-drawn angle arrays, optionally across
    `n_workers` threads (numpy's array operations release the GIL). The
    rng was already consumed by _draw_vertex_angles in instance order, so
    worker scheduling cannot change the output. Threads, not processes:
    a pool of 8 spawned processes writing the 80,000-image 32 px sets ran
    an 8-core, 96 GiB host out of memory."""
    if n_workers and len(per_image_angles) > 1:
        from multiprocessing.pool import ThreadPool

        args = [(a, scale, raster_dim, subpixel_res, shift_to_mean)
                for a in per_image_angles]
        with ThreadPool(n_workers) as pool:
            images = pool.starmap(_rasterize_polygon, args, chunksize=64)
        return np.stack(images)
    return np.stack([
        _rasterize_polygon(a, scale, raster_dim, subpixel_res,
                           shift_to_mean) for a in per_image_angles])


def generate_dataset(n_instances: int, n_vertices: int = 3,
                     min_segment_angle: float = 20.0, scale: float = 0.75,
                     raster_dim: int = 28, subpixel_res: int = 8,
                     shift_to_mean: bool = False, seed: int = 0,
                     n_workers: int = 0):
    """Returns (images [N, raster_dim, raster_dim, 1] float32 in [0, 1],
    labels [N] = n_vertices), shuffled — the notebook's GenerateDataset
    surface. `n_workers > 0` rasterizes across that many threads with
    bit-identical output (rng drawing stays sequential)."""
    if n_vertices < 3:
        raise ValueError("Need more than 2 vertices.")
    if min_segment_angle > 360.0 / n_vertices:
        raise ValueError("The minimum segment angle is infeasible.")
    if not 0.0 < scale <= 1.0:
        raise ValueError("Scale must be within (0, 1]")
    if raster_dim <= 1:
        raise ValueError("Raster sidelength has to be greater than 1.")
    rng = np.random.RandomState(seed)
    angles = [_draw_vertex_angles(rng, n_vertices, min_segment_angle)
              for _ in range(n_instances)]
    images = _rasterize_all(angles, scale, raster_dim, subpixel_res,
                            shift_to_mean, n_workers=n_workers)
    labels = np.full(n_instances, n_vertices, dtype=np.int8)
    ids = rng.permutation(n_instances)
    return images[ids, :, :, None], labels[ids]


def generate_multiclass_dataset(n_instances: int,
                                classes=(3, 4, 5, 6),
                                min_segment_angle: float = 20.0,
                                scale: float = 0.75, raster_dim: int = 32,
                                subpixel_res: int = 8,
                                shift_to_mean: bool = False, seed: int = 0,
                                n_workers: int = 0):
    """Returns (images [N, raster_dim, raster_dim, 1] float32 in [0, 1],
    labels [N] int in [0, len(classes))), shuffled. Class c rasterizes a
    classes[c]-gon — the conditional-GAN variant of the paper's
    triangles-only set: vertex count is visually decidable, so a
    class-conditional model's per-class sample grids are a direct visual
    check that label conditioning (cBN + projection D) learned.
    `n_workers > 0` rasterizes across that many threads with
    bit-identical output (rng drawing stays sequential)."""
    classes = tuple(classes)
    if any(c < 3 for c in classes):
        raise ValueError("Need more than 2 vertices.")
    if any(min_segment_angle > 360.0 / c for c in classes):
        raise ValueError("The minimum segment angle is infeasible.")
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, len(classes), size=n_instances)
    angles = [_draw_vertex_angles(rng, classes[y], min_segment_angle)
              for y in labels]
    images = _rasterize_all(angles, scale, raster_dim, subpixel_res,
                            shift_to_mean, n_workers=n_workers)
    ids = rng.permutation(n_instances)
    return images[ids, :, :, None], labels[ids].astype(np.int64)


def generate_oriented_dataset(n_instances: int,
                              classes=(3, 4, 5, 6),
                              min_segment_angle: float = 20.0,
                              scale: float = 0.75, raster_dim: int = 32,
                              subpixel_res: int = 8,
                              gradient_floor: float = 0.55,
                              seed: int = 0, n_workers: int = 0):
    """Mixed {3,4,5,6}-gons whose background is shaded by a vertical
    luminance ramp (1.0 at the top row down to `gradient_floor` at the
    bottom), giving the otherwise rotation-invariant polygon distribution
    a global orientation cue. This is the SSGAN convergence-proof
    dataset: the reference's self-supervision predicts which of 4
    rotations was applied to an image (ssgan.py:147-168), which is only a
    learnable task if the data distribution is NOT rotation-invariant —
    uniformly rotated polygons alone would leave the rotation head at
    chance by symmetry. Returns (images [N, raster_dim, raster_dim, 1]
    float32 in [0, 1], labels [N] = class index), shuffled; trained
    unconditionally."""
    classes = tuple(classes)
    if any(c < 3 for c in classes):
        raise ValueError("Need more than 2 vertices.")
    if any(min_segment_angle > 360.0 / c for c in classes):
        raise ValueError("The minimum segment angle is infeasible.")
    if not 0.0 <= gradient_floor < 1.0:
        raise ValueError("gradient_floor must be in [0, 1).")
    rng = np.random.RandomState(seed)
    ramp = np.linspace(1.0, gradient_floor, raster_dim,
                       dtype=np.float32)[:, None]
    labels = rng.randint(0, len(classes), size=n_instances)
    angles = [_draw_vertex_angles(rng, classes[y], min_segment_angle)
              for y in labels]
    images = _rasterize_all(angles, scale, raster_dim, subpixel_res,
                            n_workers=n_workers) * ramp[None]
    ids = rng.permutation(n_instances)
    return images[ids, :, :, None], labels[ids].astype(np.int64)


def _write_splits(out: str, images, labels, n_train: int, n_test: int,
                  n_holdout: int) -> str:
    """Write {train,test,holdout}.npz (uint8 images) under `out` — the
    framework's npz on-disk layout (datasets.NpzSource)."""
    os.makedirs(out, exist_ok=True)
    images = np.round(images * 255.0).astype(np.uint8)
    total = n_train + n_test + n_holdout
    splits = {"train": (0, n_train),
              "test": (n_train, n_train + n_test),
              "holdout": (n_train + n_test, total)}
    for split, (lo, hi) in splits.items():
        np.savez(os.path.join(out, f"{split}.npz"),
                 images=images[lo:hi], labels=labels[lo:hi])
    return out


def write_multiclass_npz_dataset(data_dir: str, n_train: int = 60000,
                                 n_test: int = 10000, n_holdout: int = 10000,
                                 seed: int = 0, **kwargs) -> str:
    """Write 32x32 {3,4,5,6}-gon splits as
    `<data_dir>/convex_polygons_multiclass/{train,test,holdout}.npz`,
    ready for `datasets.get_dataset("convex_polygons_multiclass")`."""
    total = n_train + n_test + n_holdout
    images, labels = generate_multiclass_dataset(total, seed=seed, **kwargs)
    return _write_splits(
        os.path.join(data_dir, "convex_polygons_multiclass"),
        images, labels, n_train, n_test, n_holdout)


def write_oriented_npz_dataset(data_dir: str, n_train: int = 60000,
                               n_test: int = 10000, n_holdout: int = 10000,
                               seed: int = 0, **kwargs) -> str:
    """Write 32x32 shaded {3,4,5,6}-gon splits as
    `<data_dir>/convex_polygons_oriented/{train,test,holdout}.npz`, ready
    for `datasets.get_dataset("convex_polygons_oriented")` — the SSGAN
    (rotation self-supervision) convergence-proof dataset."""
    total = n_train + n_test + n_holdout
    images, labels = generate_oriented_dataset(total, seed=seed, **kwargs)
    return _write_splits(
        os.path.join(data_dir, "convex_polygons_oriented"),
        images, labels, n_train, n_test, n_holdout)


def write_multiclass128_npz_dataset(data_dir: str, n_train: int = 20000,
                                    n_test: int = 4000, n_holdout: int = 4000,
                                    seed: int = 0, **kwargs) -> str:
    """Write FLAGSHIP-RESOLUTION 128x128 {3,4,5,6}-gon splits as
    `<data_dir>/convex_polygons_multiclass_128/{train,test,holdout}.npz`,
    ready for `datasets.get_dataset("convex_polygons_multiclass_128")` —
    the BigGAN-128 convergence-proof dataset (the reference's headline
    recipe resolution, reference resnet_biggan.py:18-25). Same geometry
    as the 32px multiclass set; `subpixel_res` defaults to 4 (the raster
    is 4x finer, so 4x4 subpixel AA already gives sub-1% edge error and
    keeps generation tractable)."""
    kwargs.setdefault("raster_dim", 128)
    kwargs.setdefault("subpixel_res", 4)
    total = n_train + n_test + n_holdout
    images, labels = generate_multiclass_dataset(total, seed=seed, **kwargs)
    return _write_splits(
        os.path.join(data_dir, "convex_polygons_multiclass_128"),
        images, labels, n_train, n_test, n_holdout)


def write_partial_npz_dataset(data_dir: str, labeled_frac: float = 0.2,
                              n_train: int = 60000, n_test: int = 10000,
                              n_holdout: int = 10000, seed: int = 0,
                              **kwargs) -> str:
    """Write the PARTIALLY-LABELED multiclass splits as
    `<data_dir>/convex_polygons_partial/{train,test,holdout}.npz` — the
    S3GAN convergence-proof dataset ("High-Fidelity Image Generation With
    Fewer Labels" regime). Identical images to the multiclass set, but
    only `labeled_frac` of the TRAIN labels survive; the rest become -1,
    which one-hots to an all-zero row — the reference's "no label was
    passed" contract the predictor head keys on (reference
    s3gan.py:105,118-122). test/holdout keep every label so held-out
    predictor accuracy is measurable."""
    if not 0.0 < labeled_frac <= 1.0:
        raise ValueError("labeled_frac must be in (0, 1].")
    total = n_train + n_test + n_holdout
    images, labels = generate_multiclass_dataset(total, seed=seed, **kwargs)
    rng = np.random.RandomState(seed + 1)
    drop = rng.uniform(size=n_train) >= labeled_frac
    labels = labels.copy()
    labels[:n_train][drop] = -1
    return _write_splits(
        os.path.join(data_dir, "convex_polygons_partial"),
        images, labels, n_train, n_test, n_holdout)


def write_partial_oriented_npz_dataset(data_dir: str,
                                       labeled_frac: float = 0.2,
                                       n_train: int = 60000,
                                       n_test: int = 10000,
                                       n_holdout: int = 10000,
                                       seed: int = 0, **kwargs) -> str:
    """Write PARTIALLY-LABELED ORIENTED multiclass splits as
    `<data_dir>/convex_polygons_partial_oriented/{...}.npz`: the
    vertical-ramp shading (the SSGAN proof's orientation cue) plus the
    S3GAN 20%-labels regime. On this set BOTH of S3GAN's auxiliary
    signals are live: rotation prediction is learnable (the ramp breaks
    rotation invariance) AND the predictor must impute labels — unlike
    `convex_polygons_partial`, whose uniformly rotated polygons make
    the rotation pretext unlearnable by construction (its weight-1.0
    CE then feeds constant-magnitude noise gradients into D's trunk; see
    docs/convergence_s3gan/README)."""
    if not 0.0 < labeled_frac <= 1.0:
        raise ValueError("labeled_frac must be in (0, 1].")
    total = n_train + n_test + n_holdout
    images, labels = generate_oriented_dataset(total, seed=seed, **kwargs)
    rng = np.random.RandomState(seed + 1)
    drop = rng.uniform(size=n_train) >= labeled_frac
    labels = labels.copy()
    labels[:n_train][drop] = -1
    return _write_splits(
        os.path.join(data_dir, "convex_polygons_partial_oriented"),
        images, labels, n_train, n_test, n_holdout)


def write_npz_dataset(data_dir: str, n_train: int = 60000,
                      n_test: int = 10000, n_holdout: int = 10000,
                      seed: int = 0, **kwargs) -> str:
    """Write the paper's 60k/10k/10k triangle splits as
    `<data_dir>/convex_polygons/{train,test,holdout}.npz` (uint8), ready
    for `datasets.get_dataset("convex_polygons")`."""
    total = n_train + n_test + n_holdout
    images, labels = generate_dataset(total, seed=seed, **kwargs)
    return _write_splits(os.path.join(data_dir, "convex_polygons"),
                         images, labels, n_train, n_test, n_holdout)


# Each polygon set's writer, by its dataset name.
WRITERS = {
    "convex_polygons": write_npz_dataset,
    "convex_polygons_multiclass": write_multiclass_npz_dataset,
    "convex_polygons_multiclass_128": write_multiclass128_npz_dataset,
    "convex_polygons_oriented": write_oriented_npz_dataset,
    "convex_polygons_partial": write_partial_npz_dataset,
    "convex_polygons_partial_oriented": write_partial_oriented_npz_dataset,
}
