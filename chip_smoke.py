#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``threecrate_tpu_torch``) on one
NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failed check raises and the script exits non-zero:

1. print the card (``torch.cuda.get_device_name`` and nvidia-smi's name
   and power limit); exit non-zero without CUDA;
2. build the CUDA kernels from ``threecrate_tpu_torch/csrc``;
3. compare each kernel with its plain PyTorch version on the same inputs
   at the slices' real shapes: the two union-window passes on a
   1,000,192-point Morton-sorted scan (at k = 10, band 16, at GICP's
   k = 20, the band widened to 20, and at the reconstruction analysis's
   k = 8), ``icp_match`` on 1M x 1M with
   w_tiles=3 at E=0, 3 and 6 (the match row bit-equal, every row
   bit-equal on the points whose nearest target is unique and within
   ``ICP_ABS_TOL`` where ties average), the four FPFH kernels on the 1,000,192
   sorted points of the registration target (r = 0.5, tile 256, and at
   the default FPFH's stage-2 radius r = 0.25), the
   two banded SPFH kernels on the same points (r = 0.25, band 48, tile
   256; all 34 rows on every column, padding included, with the pairs
   each query selects, the drain rounds of a warp's pair queue and the
   offsets at which some lane of a warp selects), ``knn_window_tiles``
   on the sorted 1M scan (tile 128) at k = 10,
   k = 10 with coordinates, k = 9, k = 64 with self excluded and k = 128
   with coordinates and self excluded (its plain version timed once), the
   four SHOT/USC kernels on the same sorted target points (r = 0.25,
   band 32, tile 256; the moments standalone and placed as
   ``_shot_fused`` merges them: pass B written at each position's pass-A
   row of a NaN-filled query-major buffer, then pass A adding it, held
   to the plain placed merge and to ``mom_a.T + mom_b.T[argsort(row_a)]``;
   the histograms in both variants, on one set of frames built from the
   plain merged moments, standalone and placed as ``_shot_fused`` places
   them: pass B written at each position's input row of a query-major
   buffer, then pass A added at its own; each twice, the two calls
   bit-equal), and ``window_normals_tiles`` on
   the sorted 1M scan (k = 10, tile 256) at band 16 (``window_fast``'s
   shape) and band 0 (the exact body);
4. time each kernel and its plain version (CUDA-event medians), with the
   card's SM clock read beside each; then descriptor matching's kernel
   (``match_nearest``, ``csrc/match.cu``) at the relocalize cell's
   shapes, 16,384 x 2^20 x 33 each direction, against its plain version
   (the tiled ``neighbors.knn``; rows equal on >= 99.9%, d2 within
   ``D2_ULPS`` ulps of |q|^2 + |p|^2 where they are), timed beside it,
   beside its bound and beside a library yardstick the port never calls
   (a chunked cuBLAS product with the norms and ``argmin``);
5. run ``PerceptionStep()`` on a 1M-point scan pair (target = source +
   (0.05, -0.03, 0.02)) with every launch counter reset just before:
   the shift must come back within 1e-3, valid normals must be unit
   length, and its kernels (and no others) must have launched;
6. time that step (median of 3 after one warm-up) and its peak memory;
7. run a 2,048-point ``PerceptionStep()``, the exact-kNN path;
8. run ``RegistrationModel`` (FPFH + RANSAC, then ICP) on a 1M scan pair
   (source = target rotated 0.35 rad about z and shifted by
   (2.0, -1.5, 0.3) m) with every launch counter reset just before: the
   pose must come back (|R'R - I| <= 1e-3, |R't + t'| <= 1e-2 m), each
   FPFH and union kernel must launch twice (once per cloud), the matching
   kernel twice (once a direction), ``icp_match`` at least once, the
   banded and window kNN kernels never;
9. time that call (median of 3 after one warm-up), its peak memory, and
   each stage alone: normals, FPFH, matching, RANSAC, ICP;
10. run ``RegistrationModel`` on 700 points (the exact FPFH path; the
    matching kernel the only one, twice);
11. ``extract_fpfh_features(target)`` with default settings on the 1M
    registration target: ``band="auto"`` must resolve to a rung (48
    there), union, band and weight kernels launch once each, the
    full-window SPFH kernels never; descriptors normalised, valid share
    > 0.9, median cosine >= 0.99 against ``band=None`` on the same cloud
    and normals; times of both band settings, peak memory and a device
    profile of one call;
12. ``method="window"`` normals on the 1M scan: ``knn_window`` twice,
    the union kernels never, valid share > 0.99, unit normals, median
    |cos| >= 0.999 against the default union normals; time and device
    busy time (one profiled call);
13. ``statistical_outlier_removal`` with defaults (k = 8, std 1.0) on
    the 1M scan: ``knn_window`` twice; on a strided subset of 16,384
    points the window path's mean neighbour distance agrees with the
    exact one (``neighbors.knn`` candidates, distances recomputed as
    direct differences) within 1e-4 relative on >= 80% (a point whose 8
    neighbours the two passes do not all find differs) and is not below
    it on >= 99.9%; time and device busy time;
14. ``extract_fpfh_features_with_normals(FpfhConfig(soft_binning=True))``
    on the 1M target (the staged window FPFH): ``knn_window`` twice at
    k = 64 with self excluded, no FPFH kernel; descriptors normalised;
    time, peak memory and device busy time;
15. ``extract_shot_features(target)`` with default settings on the 1M
    target: union, SHOT moments and SHOT histogram kernels launch once
    each, no other kernel; valid descriptors unit length; on a strided
    subset of 16,384 points, the cosine to the staged descriptor over an
    exact radius search (r = 0.25, 128 neighbours) with the same normals:
    logged over all points valid on both, and held >= 0.9 in median (the
    JAX package's fused-vs-staged bound, tests/test_features.py:425) on
    the points whose whole neighbourhood lies in the two ±band windows
    (elsewhere the band sees a Morton-dependent part of it, as
    ``ShotConfig``'s note says); time and peak memory; a device profile
    of one call (``torch.profiler``: wall, busy time, idle share, the
    largest device entries, the SHOT kernels' device times and the index
    kernels' launches) and its host syncs (``torch.cuda.set_sync_debug_mode``);
16. ``extract_usc_features(target)``: the SHOT moments and histogram
    kernels once each, the union kernels never; descriptors normalised;
    the same comparison, time, peak memory and profile as phase 15;
17. SHOT and USC on 2,048 points (the staged exact path): no SHOT kernel
    launches; descriptors normalised;
18. ``estimate_normals_detailed(method="window_fast")`` on the 1M scan
    (the JAX benchmark's headline program): ``window_normals`` exactly
    twice and no other kernel, valid share > 0.99, unit normals; on a
    strided subset of 16,384 points, the mean angle to exact k = 10
    normals within 0.5 degrees of the default union normals' and below
    0.5 degrees where the exact neighbourhood is planar, and below 0.5
    degrees on the JAX package's own 20,000-point test disc (see
    ``PLANAR_CURVATURE``); ``window_passes=1`` launches once; times of
    both, Mpts/s, peak memory and a device profile;
19. ``voxel_grid_filter(cloud, 0.2)`` on the 1M scan: no kernel; the
    voxel count equal to a float64 numpy oracle's on the same fp32 keys,
    centroids within 1e-4 m of it, the detailed variant's inverse equal
    to the oracle's; time, Mpts/s, peak memory;
20. ``icp_point_to_plane`` on the 1M pair (target normals from the
    default normals; 20 iterations, convergence 0, distance limit 1e9):
    the shift within 1e-3 m and the rotation within 1e-3 of the
    identity, ``icp_match`` launched 1-20 times with 3 payload rows and
    no other kernel; ms per iteration, peak memory, device busy time;
21. ``multiscale_icp_point_to_point`` with the default config on the
    same pair: the same pose checks, ``icp_match`` only; time;
22. ``window_fast`` (two launches), brute-force point-to-plane and the
    voxel grid (no launch) on 2,048 points;
23. ``gicp(source, target, GicpConfig(max_iterations=10))`` on the
    PerceptionStep pair (the window paths, auto subsample 8): the shift
    within 1e-3 m and the rotation within 1e-3 rad, each union kernel
    launched twice (at k = 20), ``icp_match`` once an iteration (six
    payload rows) and no other kernel, one host sync an iteration (the
    syncs of 10 iterations less those of 6); time, peak memory, busy time;
24. ``patchwork_plus_plus`` on ``scan(1M, 0)`` lowered by the sensor
    height: no kernel; the ground mask equal to the port's own CPU run on
    >= 99.9% of points; recall and precision against the unlifted points
    within 0.005 of the JAX package's on the CPU
    (``tools/family_references.py``); time, peak memory, busy time;
25. ``ndt_registration`` on ``scan(250k, 7)`` and its shifted copy (2 m
    cells, 20 iterations, auto subsample 4): no kernel; the transform
    within 1e-4 of the port's CPU run and the translation within 1e-3 m
    of what the JAX package reaches on the CPU; build and loop times;
26. ``OdometryModel()`` over 5 frames of ``scan(1M, 0)`` seen from a
    sensor moving 0.3 m and 0.01 rad of yaw a frame: each pose within
    ``ODOMETRY_TOL`` of the truth, ``icp_match`` the only kernel; ms a
    frame, launches a frame, the map's size;
27-31. the depth-camera slice (no kernel may launch), on bench.py's
    480x640 wavy depth image through [525, 525, 320, 240] from the
    identity; each entry timed (median of 3 after a warm-up, CUDA
    events) with its peak memory, device busy time and host syncs:
27. ``tsdf_integrate`` into a 256^3 volume of 4/256 m voxels: the pixel
    each voxel picks equal to the port's CPU run's on >= PIXEL_SHARE of
    the voxels and the tsdf within 1e-6 where both pick the same pixel;
    then ``tsdf_extract_surface_banded``: every surface point inside the
    image within one voxel of the input depth at its pixel;
28. ``sparse_tsdf_integrate`` into 32^3 blocks of 8 (4,096 blocks),
    without and with colour: ``n_blocks`` and ``block_keys`` equal to
    the CPU run's, weights equal on >= PIXEL_SHARE, tsdf (and colour)
    within 1e-6 where equal; the allocated interiors within 1e-5 of
    phase 27's volume where both have weight; the blocks attempted
    against those allocated;
29. ``sparse_tsdf_raycast`` at 480x640 (near 0.6, far 4.0): both
    ``materialize`` paths with equal masks, depth within 1e-6 and
    normals within 1e-5; confident depth against the input (gated at
    what the JAX package reaches, ``JAX_CONFIDENT_DEPTH_ERR`` and
    ``JAX_CONFIDENT_OVER_HALF``); the hit
    share, the march's steps and exit tests, the time at four exit-test
    spacings; ``tsdf_raycast`` of phase 27's volume;
30. ``track_frame_to_model`` (10 iterations) of the frame raycast from
    the identity moved 0.01 m in x against the model raycast from the
    identity: within 2e-3 rad and half a voxel of the truth and within
    1e-4 m of the JAX package's CPU result; iterations and host syncs an
    iteration;
31. ``FrameToModelOdometry()`` with its defaults over 8 frames of an
    analytic wavy wall rendered in float64, the sensor moving ~0.01 m
    and 0.005 rad a frame: each pose within ``F2M_TOL`` of the truth
    (the JAX package's worst frame, rounded up); ms a frame, busy time
    and host syncs of a frame;

then the surface-reconstruction slice (no kernel), each entry timed the
same way:
32. dense ``extract_soup_cubes`` of phase 27's 256^3 volume at iso 0
    (bench.py:433-456): live triangles, the same triangle multiset as
    phase 33's banded soup (rounded to 5 decimals);
33. ``extract_soup_cubes_banded`` on it, block 8, the cap the power of
    two from ``_block_active_count`` (bench.py:458-487): mask and
    vertices bit-equal to the port's CPU run on the same grid; active
    blocks against the cap;
34. ``marching_cubes`` of that grid through the device and the host weld
    (equal counts and triangle multisets), and the welded
    ``sparse_tsdf_marching_cubes_soup`` of phase 28's sparse volume
    against the dense mesh of the weight-masked volume (JAX's bounds:
    face counts within 3%, > 95% of vertices rounded to 1e-4 shared);
35. Poisson at bench.py:489-520's input, 100k points of the
    registration scan put on the unit sphere with radial normals:
    ``_solve`` on the multigrid solver (8 cycles) at 128^3 with its
    relative residual, the spread of chi over two calls and chi and iso
    against the port's CPU run (within ``POISSON_CHI_TOL`` of max|chi|),
    then ``poisson_reconstruct(PoissonConfig(depth=7))``: vertex radii
    with a median within 0.02 of 1 and a std below 0.02.

then the mesh-processing slice (no kernel of its own; the union
kernels through normals), each entry timed once warm with its peak,
device busy time and host syncs, against the references of
``tools/mesh_references.py``:
36. ``ReconstructionModel(k=10, target_faces=T)`` on 100,000 points of
    BASELINE #5's bumpy sphere at sigma 0.006 (T half the unsimplified
    faces): the JAX package's pick (MLS) and the port's CPU run's, no
    fallback, faces within 1% of the CPU run's before and after
    simplification, the share of vertices within two mean spacings of
    the input within 0.01 of the CPU run's, ``union_window_a`` and
    ``union_window_b`` launched twice each (k = 10, then k = 8); stage
    times and the union kernels' device time at k = 8;
36b. the stages up to ``select_algorithm`` at sigma 0.003 at 35k and
    100k points: ball pivoting, as the JAX package picks;
37. ``benchmarks/r3_probe.py``'s Poisson (depth 6) + QEM to half at 35k
    and 100k: faces at or below the target, the radius error against
    the bumpy sphere (median, 99th percentile) within the JAX package's,
    rounded up;
38. MLS on phase 36's clean points (search radius 4 mean spacings):
    radius search, fits and 6x6 solves and the signed field timed apart;
    against a CPU run on every 8th point;
39. alpha shape (20,000 points), ball pivoting (2,000; the candidate
    lists against the CPU's) and Delaunay (2,000) through
    ``auto_reconstruct_detailed``: faces within 1% of the CPU run's;
40. Laplacian, Taubin and HC smoothing of phase 34's mesh (two calls and
    the CPU run within 1e-5 m), clustering and edge collapse of phase
    37's Poisson mesh, the three booleans of two 256-face spheres, and a
    ``ProgressiveMesh`` saved, loaded and refined back to its input.

The file-to-segments slice (phases 41-43, no kernel of its own; the host
parse needs the native library, which the script asserts is loaded):
41. phase 5's pair, each cloud with a seeded intensity column, written
    to ``.bin``, binary and ASCII PLY, binary and ``binary_compressed``
    PCD and ``.xyz`` and read back onto the card: binary formats
    bit-equal to the arrays written, ASCII ones bit-equal to NumPy's
    parse of the same text; the host parse timed as bench.py's read
    lines time it (``read_ply_raw``, ``read_kitti_bin_raw``: 2 warm-ups,
    median of 5) and each whole read to the card; ``PerceptionStep()``
    on the pair read from ``.bin``: phase 5's pose and kernel 1-3
    launches; phase 34's mesh through PLY (bit-equal), OBJ (the text's
    6 digits) and STL (against a plain weld of the same file);
42. a street of ~1M points (the ground of the 1M scan and 40 car-sized
    boxes) written to binary PCD, read back, then ``voxel_grid_filter``
    at 0.1 m, ``segment_plane`` (0.15 m, 1,000 hypotheses),
    ``extract_plane(negative=True)`` and ``extract_euclidean_clusters``
    (0.3 m, at least 100 voxels): a level plane, 40 clusters each drawn
    from one box and holding that box's voxels above the band; the
    plane against the port's CPU run, the radius search on 4,096
    sampled voxels against the CPU's, and the CPU's propagation and
    ranking of the card's neighbour lists against the card's labels;
    each stage timed with busy time, peak and the propagation's
    iterations and host syncs;
43. ``knn_grid(k=10)`` on the 1M scan with ``estimate_cell_size``:
    recall of the exact 10 nearest on 4,096 sampled queries at least
    the JAX package's on the CPU; validity and ids (where the distances
    are apart) equal to the port's CPU run on those queries, distances
    within an ulp (the card's sqrt of the same d²);
44. a 10M-point aerial tile (1 km² at 10 points/m²: terrain, gabled
    roofs, tree crowns; point format 3 with intensity, GPS time and RGB
    at scale 1e-3) written as ``.las`` and chunked ``.laz`` and read onto
    the card: every array bit-equal between the two and to a plain NumPy
    int·scale + offset decode of the records; 1M of it through LAS 1.4
    format 6; file sizes, write and read times, the LASzip decompress,
    the host parse and the upload timed;
45. the tile as binary PLY streamed by ``read_point_cloud_iter`` in
    65,536-point chunks (153) through ``run_pipeline`` into
    ``StreamingVoxelFilter(0.5)`` (its state on the card),
    ``StreamingStatistics`` and ``StreamingDeviceMap`` over
    ``estimate_normals(k=10)``: kernels 1-2 once a chunk; voxel rows in
    the CPU run's order within an fp32 ulp (differences counted),
    statistics within 1e-12, the first, middle and last chunks' normals
    at |cos| >= 0.9999 against the CPU run; busy and idle time under the
    profiler, host syncs a chunk; then 10 Ouster OS1-128 frames in
    2,048-point packets through ``RealtimeVoxelFilter(0.5)`` by blocking
    send (nothing dropped, the streaming filter's keys, counts and
    centroids), with the points a second it sustained;
46. phase 42's street coloured from six seeded 1920x1080 uint8 views:
    ``colorize_point_cloud`` in both modes and ``colorize_from_images``
    over all six, the card's pixel coordinates and colours bit-equal to
    the CPU run's;
47. the other formats at 1M: E57 (cartesian bit-equal, spherical within
    2 fp32 ulp), a rosbag2 ``.db3`` and an ``.mcap`` of 10 PointCloud2
    messages of 131,072 points (xyz, intensity, rgb) read with and
    without ``topic=``, ``.tcz`` (its 14-bit lattice), ``.glb`` of phase
    34's mesh and ``.npz`` artifacts of a cloud, that mesh and phase 27's
    256^3 volume, each read back onto the card.

The multi-shard points axis (phases 48-51; ``parallel``: eight shards of
one mesh, all on the card, so the runs measure the algorithm and not an
interconnect), each entry's gated call run under the profiler and timed
with its busy time, peak, host syncs and launches:
48. a shuffled 8,388,608-point scan (``scan(8_388_608, 0)``, the 8M of
    docs/benchmarks.md:365-374) through ``make_distributed_morton_sort``:
    gid a permutation, the points ``pts[gid]``, the keys and the order of
    the stable sort of ``morton_keys`` (ties in input order); then
    ``make_sharded_normals_window``: ``window_normals`` once a shard (8),
    the result equal bit for bit to the ``presorted=True`` call on
    ``morton_presort``'s layout routed back by its perm, and the planar
    points of a 16,384-point sample within 0.5 degrees of exact k = 10
    normals (phase 18's gate) or within ``SEAM_TOL_DEG`` of the
    single-device one-pass ``window_fast`` (the entry makes one Morton
    pass, phase 18's two); steady-state times of both;
49. ``make_sharded_voxel_filter(0.2)`` on those points: the voxel rows and
    count of ``voxel_grid_filter(0.2)``, centroids within ``VOXEL_TOL`` of
    float64 centroids of its voxels or within twice the single-device
    path's own error (both sum in fp32, in other orders);
    ``make_sharded_outlier_stats(k=8)`` at 131,072 points against the mask
    from ``neighbors.knn``'s mean distances (>= 99.9% equal);
50. at 131,072 points (a (16,384 x 16,384) tile a ring step): ring kNN
    (k = 10) against ``neighbors.knn`` (d2 within 4 ulps of |q|^2 + |p|^2,
    ids equal where apart), ring normals against the exact path at k = 11
    (|cos| >= 0.9999 on 99.9%), sharded point-to-point, point-to-plane
    and GICP on phase 5's shift (10 iterations): the shift within 1e-3 m,
    the rotation within 1e-3, and the single-device entry's pose within
    1e-3; batch ICP on a 2 x 4 mesh with two 65,536-point pairs within
    5e-3 m;
51. the registration pair's rotation and shift at 131,072 points: sharded
    FPFH (r = 0.5, k = 64) against the staged ``_fpfh`` on the same normals
    (cosine median >= 0.999, mean >= 0.99), sharded matching against
    ``match_descriptors`` (ids on 99%, d2 within 4 ulps), and ``make_sharded_global_registration``'s pose
    within 5e-3 of the truth.

The user-facing surface (phases 52-54): the root names of ``api`` and
``compat`` driven from NumPy arrays as a user of the reference module
calls them, the debug hooks and ``viz`` (no PNG: the card machine has no
PIL), each gated against the native call or the port's CPU run:
52. on ``scan(1_048_576, 52)`` as a NumPy array: ``tt.estimate_normals(p)``
    and ``tt.estimate_normals(p, k_neighbors=8)`` (the union kernels once
    each, normals on the card bit-equal to the native call on
    ``PointCloud.from_numpy(p)``), ``tt.icp(src, tgt, 30,
    init_transform=m4)`` (``icp_match`` once an iteration, a callable
    4x4 equal to the native call with ``init=Transform.from_matrix(m4)``,
    the shift within 1e-3), ``tt.extract_fpfh_features(cloud, 0.25, 10)``
    (an (N, 33) array equal to the native descriptors' valid rows; the
    union, banded SPFH and weight kernels once each),
    ``tt.global_registration`` in the reference's positional convention
    on the registration pair (the union, SPFH, weight kernels twice and
    ``icp_match``; phase 8's gate, the native call's pose),
    ``tt.simplify_mesh(mesh, 0.5)`` on a 25,600-face UV sphere (12,800
    faces), ``tt.remove_statistical_outliers(p)`` (the window kNN kernel:
    1M is above its 262,144-point threshold; the native call's mask),
    ``tt.voxel_downsample(p, 0.05)`` and ``tt.transform_point_cloud(p,
    m4)`` (bit-equal to the native calls) and the prelude's names; each
    adapter's time beside its native call's;
53. ``utils.profiling.trace(log_dir)`` around one ``PerceptionStep`` (the
    trace names the union and ICP kernels), ``median_time(fn, sync_fn=...)``
    (``sync_fn`` applied to every result) and ``utils.debug.nan_checks()``
    (raises on a NaN on the card; its cost on a clean ``PerceptionStep``);
54. ``viz`` at full width: ``render_point_cloud`` of the 1M scan at 640x480
    and 1280x720 (``point_size=2``) against the port's CPU run (within
    1e-6 on >= 99.5% of pixels), ``render_mesh``, ``render_mesh_pbr`` and
    ``render_to_texture`` (both modes, against the direct call) of a
    102,400-face UV sphere at 640x480 against the CPU raster of 2,048
    sampled pixels (within 1e-5 on >= 99%), and ``InteractiveViewer(960, 720)`` with keys, ``render``,
    ``frame_ansi``, ``run_plane_segmentation`` and ``run_icp`` (``icp_match``
    once an iteration); each timed with its busy time, peak and host syncs;
55. the x-slab TSDF (``parallel.make_sharded_tsdf``) on eight shards of the
    card: phase 28's frame into phase 28's grid, 2,048 blocks a shard, the
    union of the shards' blocks bit-equal to the single-device
    ``sparse_integrate`` (keys, tsdf, weights, counts), the surface points
    and the marching-cubes triangles the single-device multisets (5
    decimals), the halo-extended raycast at 480x640 against the
    single-device ``sparse_tsdf_raycast`` (JAX's gates: mask disagreement
    < 1%, depth within a voxel where both are confident, a median normal
    dot > 0.999);
56. ``ShardedFrameToModelOdometry()`` over phase 31's 8 wall frames: poses
    within phase 31's tolerance of the truth, their distance from
    ``FrameToModelOdometry()`` on the same frames, ms, busy time and host
    syncs a frame;
57. the sharded NDT (phase 25's pair, stride 1) against
    ``ndt_registration`` (1e-3 m and rad), ground on phase 24's scan
    against ``patchwork_plus_plus`` (mask >= 99%, patch normals), clusters
    on 131,072 of phase 42's box samples (40, labels and sizes equal),
    SHOT and USC on 131,072 points against the staged path (valid equal,
    median cosine > 0.99999), MLS against ``mls_smooth`` (>= 98% within
    1e-4), plane RANSAC at phase 42's 0.15 m on 1,048,576 points against
    ``segment_plane`` (cosine > 0.9999, masks >= 99.9%) and colorize from
    six 1080p views against ``colorize_from_images`` (bit-equal);
58. the x-slab multigrid at 128³ on phase 35's right-hand side against
    ``mg_solve`` (1e-6 of max|x|), the sharded fields against ``_solve``
    and ``make_sharded_poisson(PoissonConfig(depth=7))`` on phase 35's
    sphere (radii); phases 55-58 launch no kernel, each gated call
    profiled: ms, busy, idle share, peak, host syncs, device ops.

Phases 44-58 print the card's name, power limit and SM clock beside
their times. The last three lines are the card (nvidia-smi's name and power limit),
one JSON object with each kernel's launches (over the runs of phases 5,
8, 11-16, 18, 20, 21, 23-36, 41, 45, 48 and 52-58; the FPFH kernels' r = 0.25 entries and
the union kernels' k = 20 and k = 8 entries repeat the kernel's count, each
``knn_window`` entry counts its own shape's launches), error, times and
bound, then ``{"ok": true, "device":
{...}}``. A kernel's bound is the larger of the bytes it must move
(each input read once, each output written once) over the H100's
3.35 TB/s and the fp32 operations of its algorithm on this run's inputs
(per examined candidate and per selected pair, counted as each source's
note says) over 67 TFLOP/s. The full-window FPFH kernels (6-9),
``icp_match`` and ``knn_window`` examine only the candidates of the
16-column chunks that their box test cannot exclude for the query (at
r2, the nearest d² or the k-th d²), counted on this run's inputs; phase
3 logs them per query.
"""

from __future__ import annotations

import copy
import functools
import importlib
import json
import math
import re
import sqlite3
import struct
import subprocess
import sys
import time
import warnings
from pathlib import Path

import numpy as np
import torch

N_SCAN = 1_000_000
SHIFT = np.array([0.05, -0.03, 0.02], np.float32)
# Radius and counts of the union kernels must equal the plain version's
# bit for bit: both evaluate the same unfused fp32 operations. The sums
# differ only by summation order.
SUM_REL_TOL = 1e-4      # |Δ sum| / scale of the query's neighbourhood
ICP_ABS_TOL = 1e-4      # metres, on coordinates of magnitude <= ~150 m
# The FPFH vote and count rows must equal the plain version's bit for
# bit (integer votes of the same unfused fp32 features); the stage-2
# weighted sums differ only by summation order.
FPFH_REL_TOL = 1e-4     # max |Δ| / Σ|row| of the query's 33 sums
FPFH_RADIUS, FPFH_TILE = 0.5, 256
FPFH_KERNELS = ("spfh_a", "spfh_b", "fpfh_weight_a", "fpfh_weight_b")
BAND_RADIUS, BAND = 0.25, 48    # the rung "auto" picks on the registration target
# the stage-2 kernels at RegistrationModel's radius and at the default
# FPFH's (BAND_RADIUS), by timing name
WEIGHT_RUNS = {"fpfh_weight_a": FPFH_RADIUS, "fpfh_weight_b": FPFH_RADIUS,
               "fpfh_weight_a r=0.25": BAND_RADIUS, "fpfh_weight_b r=0.25": BAND_RADIUS}
# the stage-1 kernels likewise; the plain versions (~0.4 s a call) of the
# r = 0.25 runs are timed once a side
SPFH_RUNS = {"spfh_a": FPFH_RADIUS, "spfh_b": FPFH_RADIUS,
             "spfh_a r=0.25": BAND_RADIUS, "spfh_b r=0.25": BAND_RADIUS}
SPARE_PLAIN = ("spfh_a r=0.25", "spfh_b r=0.25", "knn_window k=128 coords exclude_self")
BAND_KERNELS = ("spfh_band_a", "spfh_band_b")
# knn_window_tiles configurations of the window paths (k, with_coords,
# exclude_self), all at tile 128: method="window" normals (k = 10), its
# coordinate output, outlier removal (k + 1 = 9) and the staged FPFH
# (max_neighbors = 64, self excluded). -d^2, ids and coordinates must
# equal the plain version's in every slot.
KNN_CONFIGS = {"k=10": (10, False, False), "k=10 coords": (10, True, False),
               "k=9": (9, False, False), "k=64 exclude_self": (64, False, True)}
KNN_TILE = 128
# the largest k of the kernel (radius_neighbors_window's max_neighbors),
# checked and timed beside KNN_CONFIGS, its plain version once
KNN_K128 = "k=128 coords exclude_self"
KNN_SHAPES = {**KNN_CONFIGS, KNN_K128: (128, True, True)}
# icp_match payload rows checked at full size: none, point-to-plane's
# normals and the six rows GICP carries
ICP_EXTRAS = (0, 3, 6)
# The SHOT/USC kernels at ShotConfig's defaults. Moment count rows and
# histogram count rows must equal the plain version's bit for bit, USC
# histograms in every row (integer votes of the same unfused bins); the
# moment sums and the SHOT soft votes differ only by summation order.
SHOT_RADIUS, SHOT_BAND, SHOT_MAX_NEIGHBORS = 0.25, 32, 128
SHOT_REL_TOL = 1e-5     # moments: |Δ| / Σw·R^k; SHOT votes: |Δ| / count
SHOT_KERNELS = ("shot_moments_a", "shot_moments_b", "shot_hist_a", "shot_hist_b")
# window_normals_tiles at the window_fast shape (band 16) and the exact
# body (band 0), on the sorted 1M scan (k = 10, tile 256). The count and
# k-th rows must equal the plain version's bit for bit (the same unfused
# fp32 selection); all six rows equal on >= NORMALS_EQUAL_SHARE of the
# valid queries and the normal and curvature rows within NORMALS_ABS_TOL
# on as many (both sides round float64 selection sums once to fp32, in
# different orders, so a sum that lands within 2^-53 of an fp32 rounding
# boundary may round the other way).
NORMALS_BANDS = {"window_normals": 16, "window_normals band=0": 0}
NORMALS_EQUAL_SHARE, NORMALS_ABS_TOL = 0.9999, 1e-5
NORMALS_EIG_OPS = 550     # per query: covariance and 4-sweep Jacobi eigensolve
# Exact k = 10 normals of the 1M scan are noise-dominated (5 cm-thick
# ground at cm spacing, 30% of points lifted at random): any window
# path's mean angle to them is several degrees, the default union's
# included. Phase 18 holds window_fast within 0.5 degrees of the union's
# mean, and below 0.5 degrees (the JAX test's bound) where the exact
# neighbourhood is planar (surface variation below PLANAR_CURVATURE)
# and on the JAX test's own 20,000-point disc.
PLANAR_CURVATURE = 0.01
VOXEL = 0.2               # the voxel grid's size at 1M (bench.py's)
VOXEL_TOL = 1e-4          # metres: fp32 centroid sums vs the float64 oracle
# tc::chunk_beyond's box test of a chunk for a query: 6 differences, 7
# maxima, 3 products, 2 sums, the margin product and a compare
BOX_TEST_OPS = 20
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory
FP32_OPS_PER_S = 67e12      # H100 SXM fp32 outside the tensor cores
# Patchwork++ (phase 24): the default sensor height, and the recall and
# precision of the JAX package's patchwork_plus_plus on the CPU against
# ground_scan()'s labels (python3 tools/ground_reference.py); the port
# on the card must come within GROUND_GATE of each
SENSOR_HEIGHT = 1.723
JAX_GROUND_RECALL, JAX_GROUND_PRECISION = 0.9855278973146717, 0.9864019534496496
GROUND_GATE = 0.005
# NDT (phase 25), as bench.py's ndt_250k_build20iter_ms line runs it
NDT_POINTS = 250_000
NDT_CONFIG = dict(resolution=2.0, max_iterations=20, epsilon=0.0)
# what the JAX package's ndt_registration reaches on phase 25's pair on
# the CPU (tools/family_references.py ndt); the applied shift is SHIFT
JAX_NDT_TRANSLATION = (0.00285716587677598, -0.003976220730692148, 0.10302392393350601)
# OdometryModel (phase 26): frames of scan(1M, 0) from a sensor moving
# ODOMETRY_STEP (m, rad of yaw) a frame
ODOMETRY_FRAMES = 5
ODOMETRY_STEP = (0.3, 0.01)
# each pose against the truth (m, rad): the scan is a ring of uniform
# angle on flat ground, so yaw, and x and y through it, are held only by
# the density's noise; the JAX package's own worst frame on the CPU is
# 0.0898 m and 4.27e-3 rad (tools/family_references.py odometry), rounded
# up here
ODOMETRY_TOL = (0.1, 5e-3)
# The depth-camera slice (phases 27-31): bench.py's 480x640 wavy depth
# image (2.0 + 0.3·sin(x/60)·cos(y/45) m) seen through intrinsics
# [525, 525, 320, 240] from the identity, fused into a 256^3 grid of
# 4/256 m voxels at origin (-2, -2, 0.5): dense, or 32^3 blocks of 8 with
# 4,096 blocks (bench.py:402-430, :536-612)
DEPTH_HW = (480, 640)
DEPTH_INTR = np.array([525.0, 525.0, 320.0, 240.0], np.float32)
TSDF_RES, TSDF_VOXEL, TSDF_ORIGIN = 256, 4.0 / 256, (-2.0, -2.0, 0.5)
TSDF_GRID, TSDF_MAX_BLOCKS = (32, 32, 32), 4096
RAY_NEAR, RAY_FAR = 0.6, 4.0
# phase 27: the share of voxels whose pixel the card and the CPU both
# pick (phase 28: whose weight they agree on)
PIXEL_SHARE = 0.9999
# phase 29: the raycast depth against the input on confident pixels. The
# JAX package on the CPU misses half a voxel there near the image borders
# (tools/family_references.py f2m: at most 0.01854 m sparse and 0.01901 m
# dense; 411 of 287,364 and 553 of 282,751 confident pixels beyond half a
# voxel), so the gate is what it reaches, rounded up: the largest error
# and the share of confident pixels beyond half a voxel
JAX_CONFIDENT_DEPTH_ERR, JAX_CONFIDENT_OVER_HALF = 0.02, 0.0025
# phase 30: a frame raycast from the pose moved TRACK_SHIFT m in x,
# tracked against the model raycast from the identity (bench.py:555-584);
# the pose the JAX package reaches on the CPU from its own maps
# (tools/family_references.py f2m), and the gate against it (m)
TRACK_SHIFT = 0.01
JAX_TRACK_TRANSLATION = (0.010052465833723545, 1.2806761333195027e-05, 1.2924405382364057e-05)
TRACK_JAX_TOL = 1e-4
# phase 31: FrameToModelOdometry with its defaults over F2M_FRAMES frames
# of an analytic wavy wall, z = 2 + 0.2·sin(x/0.3)·cos(y/0.25) m in the
# world, the sensor moving F2M_STEP a frame (rotations about x and y of
# 0.003 and -0.004 rad, a 0.0101 m translation); each pose against the
# truth (m, rad), gated at the JAX package's worst frame on the same
# frames on the CPU (tools/family_references.py f2m: 2.686e-4 m,
# 1.444e-4 rad), rounded up
F2M_FRAMES = 8
F2M_STEP = ((0.003, -0.004, 0.0), (0.006, -0.004, 0.007))
F2M_TOL = (3e-4, 2e-4)
# The surface slice (phases 32-35). Phase 34: the sparse mesh against the
# dense one, as tests/test_tsdf_sparse.py:118-129 bounds it (face counts,
# share of rounded vertices shared). Phase 35: bench.py's Poisson input
# (100k points of scan(·, 3) on the unit sphere, a 128^3 grid over
# [-1.2, 1.2]^3, 8 V-cycles), chi against the port's CPU run within
# POISSON_CHI_TOL of max|chi| (the CPU tests hold the port to JAX's within
# that: measured 1.2e-5), and the depth-7 mesh's radii
# (tests/test_reconstruction.py:129-139)
MC_BLOCK = 8
SPARSE_MESH_FACES, SPARSE_MESH_SHARED = 0.03, 0.95
POISSON_N, POISSON_RES, POISSON_LO = 100_000, 128, -1.2
POISSON_CHI_TOL = 1e-4
POISSON_RADIUS_TOL = 0.02
# The mesh-processing slice (phases 36-40). Phase 36: ReconstructionModel
# on BASELINE config #5's generator (seed 11) at MESH_N points and
# sigma = MESH_SIGMA, about half the point spacing, where the analysis
# takes MLS; phase 36b at BASELINE5_SIGMA (the probe's own noise), where
# it takes ball pivoting; phase 37: the probe's Poisson + QEM pipeline.
MESH_N, MESH_SIGMA, MESH_SEED = 100_000, 0.006, 11
BASELINE5_SIGMA, BASELINE5_SIZES = 0.003, (35_000, 100_000)
# JAX's picks on the CPU (python3 tools/mesh_references.py picks)
JAX_PICKS = {"phase36": "mls", 35_000: "ball_pivoting", 100_000: "ball_pivoting"}
# Phase 37's gates: the JAX package's results on the CPU (tools/mesh_references.py
# poisson): face counts, and the simplified mesh's radius error against the
# bumpy sphere (median 0.00568 and 0.00717, 99th percentile 0.107 and 0.108),
# rounded up
JAX_POISSON = {35_000: {"faces": 29627, "simplified_faces": 14813, "median": 0.006, "p99": 0.11},
               100_000: {"faces": 29115, "simplified_faces": 14557, "median": 0.008,
                         "p99": 0.11}}
# The port's own CPU results (python3 tools/mesh_references.py port: tens
# of GB and minutes, too large for a CPU run inside this script): phase 36's pick, faces
# before and after simplification and share of vertices within
# NEAR_SPACINGS mean spacings of the input (MLS's sheets of unoriented
# normals put the rest elsewhere, as in the JAX package), and phase 39's
# faces; the card's counts must come within 1%, the share within
# NEAR_SHARE_TOL
PORT_CPU_MESH = {"phase36": {"algorithm": "mls", "fallbacks": [], "points": 84500,
                             "faces": 44650, "simplified_faces": 22325,
                             "near_share": 0.29279513888888886},
                 "alpha_shape": {"faces": 39703}, "ball_pivoting": {"faces": 2658},
                 "delaunay": {"faces": 3960}}
NEAR_SPACINGS, NEAR_SHARE_TOL = 2.0, 0.01
# Phase 38: MLS on the card against the CPU run on every MLS_CPU_EVERY-th
# point (the CPU's exact radius search of all ~85k would take minutes). The
# search: at most MLS_OTHER_SETS of the points find another set of 32
# neighbours (the cap cuts inside the radius, so a near tie at the 32nd
# decides), d² within MLS_D2_TOL where the ids agree (the expanded d² of
# unit-scale points rounds at ~2.4e-7). The fit alone, the card's fit of
# the CPU's own neighbourhoods: within MLS_POS_TOL of the radius and
# normals |cos| >= MLS_COS_TOL on >= MLS_SHARE of the points. End to end,
# every point within MLS_END_TOL of the radius: at 4 mean spacings a
# neighbour's d² is ~2e-4 to 3e-3, so that rounding moves the Gaussian
# weights by up to ~1e-3 and the projections with them (on an H100: 99.5%
# within 1e-5 of the radius, the largest 5.7e-3)
MLS_CPU_EVERY, MLS_POS_TOL, MLS_COS_TOL, MLS_SHARE = 8, 1e-5, 0.9999, 0.999
MLS_OTHER_SETS, MLS_D2_TOL, MLS_END_TOL = 0.005, 1e-6, 1e-2
# Phase 39's sizes, cut where the host loops set the time (ball pivoting's
# front takes milliseconds a point); phase 40: smoothing's spread between
# two calls and difference from the CPU run (m, on a 4 m volume), and the
# booleans' spheres (4·rings² faces: the host BSP's cost grows steeply
# with the faces)
ALPHA_N, BPA_N, DELAUNAY_N = 20_000, 2_000, 2_000
# BPA's candidate d² on the card against the CPU's, slot by slot: the
# expanded d² = |q|² + |p|² - 2q·p of unit-sphere points rounds at ~2.4e-7
BPA_D2_TOL = 1e-6
SMOOTH_TOL = 1e-5
BOOLEAN_RINGS = 8
# The file-to-segments slice (phases 41-43). Phase 41: the host parse is
# timed as bench.py's read lines time it; PerceptionStep on the pair read
# from .bin must give phase 5's pose within POSE_FILE_TOL, or within the
# spread of two in-memory calls where the card's reductions make that
# larger
READ_WARMUP, READ_ITERS = 2, 5
POSE_FILE_TOL = 1e-6
IO_SEED = 41
# Phase 42's street: the ground of scan_labels(1M, 0) (~700k points, 5 cm
# thick) and STREET_BOXES boxes of STREET_BOX m standing on it, each with
# STREET_BOX_SAMPLES samples on its four sides and top, on a grid at
# 10-40 m from the origin with >= 3 m between boxes; the pipeline's
# settings; a cluster must draw STREET_PURITY of its voxels from one box
# and hold STREET_PURITY of that box's voxels above the plane's band
STREET_BOXES, STREET_BOX, STREET_BOX_SAMPLES = 40, (4.5, 2.0, 1.5), 7_500
STREET_VOXEL, STREET_PLANE_TOL, STREET_RANSAC = 0.1, 0.15, 1000
STREET_TOLERANCE, STREET_MIN_CLUSTER, STREET_PURITY = 0.3, 100, 0.99
# the plane against the port's CPU run: normal and d (m), and the inlier
# count where fp32 boundary points differ
STREET_NORMAL_TOL, STREET_D_TOL, STREET_COUNT_TOL = 1e-5, 1e-4, 1e-3
# voxels whose radius search is held against the CPU's; there the
# expanded d² = |q|² + |p|² - 2q·p rounds at a few ulp of |q|² + |p|²
# (~1e-3 m² at 40 m), so the neighbour sets may differ only for points
# within STREET_D2_ULPS such ulp of the radius or of the last kept slot
STREET_SAMPLE, STREET_D2_ULPS = 4096, 8
# Phase 43: knn_grid's recall of the exact 10 nearest on GRID_SAMPLE
# queries drawn with GRID_SEED. The exact reference takes d² as
# (dx² + dy²) + dz², each step rounded to fp32 (the expanded form of
# knn loses digits at 100 m); the JAX package's recall on the same
# queries and reference on the CPU (python3 tools/io_references.py)
GRID_K, GRID_SAMPLE, GRID_SEED = 10, 4096, 43
JAX_GRID_RECALL = 0.609448254108429
# The survey-tile slice (phases 44-47). Phase 44's tile: TILE_SIDE m
# square at TILE_DENSITY points a m² from TILE_SEED (10M points), flown
# in strips TILE_STRIP m wide, GPS time from TILE_GPS_START s at
# TILE_RATE points a second, written at TILE_SCALE; LAS14_POINTS of it in
# LAS 1.4 format 6
TILE_SIDE, TILE_DENSITY, TILE_SEED, TILE_STRIP = 1000.0, 10, 44, 100.0
TILE_GPS_START, TILE_RATE, TILE_SCALE, LAS14_POINTS = 3.0e5, 200_000.0, 1e-3, 1_000_000
# Phase 45: the stream's chunks (153 of the tile), the voxel, the normals'
# k; the statistics against the CPU run (relative) and the chunk normals'
# |cos| against it; the realtime feed:
# OUSTER_FRAMES OS1-128 frames in packets of OUSTER_PACKET points (16
# columns of 128 beams)
STREAM_CHUNK, STREAM_VOXEL, STREAM_K = 65536, 0.5, 10
STATS_REL_TOL, NORMALS_COS = 1e-12, 0.9999
OUSTER_FRAMES, OUSTER_PACKET, OUSTER_SEED = 10, 2048, 45
# Phase 46: six 1080p uint8 views of phase 42's street (seeded images)
COLOR_VIEWS, COLOR_HW, COLOR_SEED = 6, (1080, 1920), 46
COLOR_INTR = (960.0, 960.0, 959.5, 539.5)
# Phase 47: the bags' PointCloud2 messages, their topic, and the seed of
# the street's intensity and colours
BAG_MESSAGES, BAG_POINTS, BAG_TOPIC, FORMATS_SEED = 10, 131_072, "/os1/points", 47
GICP_K = 20              # GicpConfig's k_correspondences: the union passes at k = 20
ANALYSIS_K = 8           # reconstruction.pipeline.analyze_data's normals: the union passes at k = 8
REG_ANGLE = 0.35
REG_SHIFT = np.array([2.0, -1.5, 0.3], np.float32)
REG_CONFIG = dict(ransac_iterations=16384, fpfh_radius=FPFH_RADIUS,
                  distance_threshold=0.3, refine_with_icp=False,
                  hypothesis_batch=4096)
# Phases 48-51: the multi-shard points axis, SHARDS shards of one mesh on
# the one card. The window, sort and voxel paths run on N_SHARDED points (the
# 8M of docs/benchmarks.md:365-374, where the sharded path takes over from
# one chip), shuffled by SHARD_SEED; the ring paths are brute force (a
# (16,384 x 16,384) fp32 tile a ring step at N_RING) and run on N_RING.
SHARDS = 8
N_SHARDED, SHARD_SEED = 8_388_608, 48
N_RING = 131_072
RING_K = 10                # ring kNN and ring normals (k + 1 with the self match)
K_NORMALS = 10             # the window normals', exact normals' and FPFH normals' k
RING_ICP_ITERS = 10
RING_POSE_TOL = 1e-3       # m and rad: the shift, and the single-device entries' poses
BATCH_POINTS = 65_536
BATCH_SHIFTS = np.array([[0.05, -0.02, 0.01], [0.01, 0.03, -0.02]], np.float32)
BATCH_POSE_TOL = 5e-3      # m: tests/test_parallel.py's bound for batch ICP and registration
SOR_K, SOR_STD = 8, 1.0    # statistical_outlier_removal's defaults
RING_FPFH_RADIUS, RING_FPFH_K = 0.5, 64
D2_ULPS = 4                # ring d2 against knn's: ulps of |q|^2 + |p|^2
# descriptor matching at the relocalize cell's shapes: queries, database, dims
MATCH_SHAPE = (16_384, 1 << 20, 33)
SEAM_TOL_DEG = 0.05        # sharded window normals' planar angle against one device's one pass
# Phases 55-58: the last of parallel on SHARDS shards of the card. Phase 55:
# phase 28's frame and grid into an x-slab TSDF of SLAB_BLOCKS blocks a shard
# (every block updated: update_fraction 1); phase 57: clusters on N_RING of
# the street's box samples (drawn with SLAB_SEED), SHOT/USC and MLS (radius
# SLAB_MLS_RADIUS) on scan(N_RING, 0), plane RANSAC and colorize on
# N_SLAB_BIG points of scan(·, 0)
SLAB_BLOCKS, SLAB_SEED, SLAB_MLS_RADIUS, N_SLAB_BIG = 2048, 55, 0.5, 1_048_576
# phase 55: the sharded raycast against the single-device one, JAX's gates
# (tests/test_parallel.py:515-543: mask disagreement < 1%, depth within a
# voxel, median normal dot > 0.999), the depth gate on the pixels both
# calls mark confident; on all hits JAX's own sharded raycast misses it at
# this size (tools/parallel_references.py slab: 0.15026% of the hits beyond
# a voxel, grazing and border pixels where a slab's march stops elsewhere,
# up to 0.0346 m), so the share is gated at JAX's, rounded up
SLAB_RAY_OVER = 0.002
# Phases 52-54: the user-facing surface. The root names run on N_ROOT
# points of scan(N_ROOT, ROOT_SEED) passed as NumPy arrays; ICP starts from
# half of phase 5's shift; simplify_mesh halves a UV sphere of 4·80² faces;
# the renders are held against the port's CPU run (points: the whole
# image, RENDER_PIXEL_TOL on >= RENDER_POINT_SHARE of pixels; meshes of
# 4·160² faces: RENDER_SAMPLE pixels, RENDER_MESH_TOL on >=
# RENDER_MESH_SHARE of them; the card's fused multiply-adds may round a
# pixel centre or an edge test the other way)
N_ROOT, ROOT_SEED = 1_048_576, 52
SIMPLIFY_SUB, RENDER_SUB = 80, 160
RENDER_SIZES = ((640, 480), (1280, 720))
RENDER_PIXEL_TOL, RENDER_POINT_SHARE = 1e-6, 0.995
RENDER_MESH_TOL, RENDER_MESH_SHARE, RENDER_SAMPLE = 1e-5, 0.99, 2048
VIEWER_SIZE = (960, 720)


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def sm_clock() -> str:
    """The card's SM clock now, as nvidia-smi reads it."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=30)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "unread"


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def scan_labels(n: int, seed: int):
    """Synthetic outdoor LiDAR-like scan: a ground ring of radius ~2-100 m,
    5 cm thick, with 30% of its points lifted up to 4 m (the JAX package's
    benchmark cloud: the same generator, seeds and arrays). Returns
    (points (n, 3) float32, ground labels (n,): the points not lifted)."""
    rng = np.random.default_rng(seed)
    ang = rng.uniform(0, 2 * np.pi, n)
    r = np.abs(rng.normal(0, 25, n)) + 2.0
    ground = np.stack([r * np.cos(ang), r * np.sin(ang), rng.normal(0, 0.05, n)], -1)
    lift = rng.uniform(0, 1, n) < 0.3
    ground[lift, 2] = rng.uniform(0, 4, lift.sum())
    return ground.astype(np.float32), ~lift


def scan(n: int, seed: int) -> np.ndarray:
    """The points of ``scan_labels``."""
    return scan_labels(n, seed)[0]


def bumpy_sphere(n: int, sigma: float, seed: int = MESH_SEED) -> np.ndarray:
    """BASELINE config #5's cloud (benchmarks/r3_probe.py:243-249): points
    of the sphere of radius 1 + 0.05·sin 3u, u the azimuth, with
    normal(0, sigma) noise."""
    rng = np.random.default_rng(seed)
    u, v = rng.uniform(0, 2 * np.pi, n), np.arccos(rng.uniform(-1, 1, n))
    sphere = np.stack([np.sin(v) * np.cos(u), np.sin(v) * np.sin(u), np.cos(v)], -1)
    return (sphere * (1 + 0.05 * np.sin(3 * u)[:, None])
            + rng.normal(0, sigma, (n, 3))).astype(np.float32)


def bumpy_radius_error(v: np.ndarray) -> np.ndarray:
    """|‖p‖ − (1 + 0.05·sin 3u)| of each vertex p, u its azimuth."""
    u = np.arctan2(v[:, 1], v[:, 0])
    return np.abs(np.linalg.norm(v, axis=1) - (1 + 0.05 * np.sin(3 * u)))


def fibonacci_sphere(n: int) -> np.ndarray:
    """examples/reconstruction_pipeline.py's unit sphere."""
    i = np.arange(n, dtype=np.float64)
    phi = np.arccos(1 - 2 * (i + 0.5) / n)
    theta = np.pi * (1 + 5 ** 0.5) * i
    return np.stack([np.cos(theta) * np.sin(phi), np.sin(theta) * np.sin(phi), np.cos(phi)],
                    -1).astype(np.float32)


def terrain(n: int, seed: int = 5) -> np.ndarray:
    """A wavy height field over the unit square."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, 1, (n, 2))
    z = 0.05 * np.sin(xy[:, 0] * 6) * np.cos(xy[:, 1] * 5)
    return np.stack([xy[:, 0], xy[:, 1], z], -1).astype(np.float32)


def ground_scan():
    """Patchwork++'s 1M input: ``scan(1M, 0)`` lowered by the sensor height
    (Patchwork++ looks for ground near z = −1.723 m), with its labels."""
    pts, labels = scan_labels(N_SCAN, 0)
    pts[:, 2] -= SENSOR_HEIGHT
    return pts, labels


def recall_precision(got: np.ndarray, labels: np.ndarray):
    """(share of labelled ground found, share of found points that are
    labelled ground)."""
    return float(got[labels].mean()), float(labels[got].mean()) if got.any() else 0.0


def grid_sample() -> np.ndarray:
    """Phase 43's GRID_SAMPLE query rows of the 1M scan, sorted."""
    return np.sort(np.random.default_rng(GRID_SEED).choice(N_SCAN, GRID_SAMPLE, replace=False))


def exact_nearest(db: torch.Tensor, q: torch.Tensor, k: int, chunk: int = 32) -> torch.Tensor:
    """(Q, k) ids of the k nearest ``db`` rows of each query, by d² =
    (dx² + dy²) + dz² with each step rounded to fp32 (the same bits on
    the card and the CPU), ``chunk`` queries against all of ``db`` at a
    time."""
    out = []
    for c0 in range(0, q.shape[0], chunk):
        diff = q[c0:c0 + chunk, None, :] - db[None]
        d2 = diff[..., 0] * diff[..., 0] + diff[..., 1] * diff[..., 1] \
            + diff[..., 2] * diff[..., 2]
        out.append(torch.topk(d2, k, dim=1, largest=False).indices)
    return torch.cat(out)


def grid_recall(ids: torch.Tensor, valid: torch.Tensor, exact: torch.Tensor) -> float:
    """Share of the exact neighbours that the valid slots of ``ids`` hold."""
    hits = ((ids[:, :, None] == exact[:, None, :]) & valid[:, :, None]).any(1)
    return float(hits.float().mean())


def street_scene():
    """Phase 42's street: (points (n, 3) float32, source (n,) int32: -1 for
    the ground of ``scan_labels(1M, 0)``, b for a sample of box b). The
    boxes stand on z = 0, axis-aligned, their centres drawn from a grid
    (pitch: the box plus 3.5 m in x, 4 m in y) at 10-40 m from the
    origin; each face gets samples in proportion to its area."""
    pts, labels = scan_labels(N_SCAN, 0)
    ground = pts[labels]
    rng = np.random.default_rng(42)
    lx, ly, lz = STREET_BOX
    cand = np.array([(x, y) for x in np.arange(-40.0, 40.01, lx + 3.5)
                     for y in np.arange(-40.0, 40.01, ly + 4.0) if 10 <= np.hypot(x, y) <= 40])
    centres = cand[rng.choice(len(cand), STREET_BOXES, replace=False)]
    # faces of a box with its min corner at 0: (origin, e1, e2)
    faces = np.array([[(0, 0, 0), (0, ly, 0), (0, 0, lz)], [(lx, 0, 0), (0, ly, 0), (0, 0, lz)],
                      [(0, 0, 0), (lx, 0, 0), (0, 0, lz)], [(0, ly, 0), (lx, 0, 0), (0, 0, lz)],
                      [(0, 0, lz), (lx, 0, 0), (0, ly, 0)]])
    area = np.array([ly * lz, ly * lz, lx * lz, lx * lz, lx * ly])
    n = STREET_BOXES * STREET_BOX_SAMPLES
    box = np.repeat(np.arange(STREET_BOXES), STREET_BOX_SAMPLES)
    face = rng.choice(5, n, p=area / area.sum())
    uv = rng.uniform(0, 1, (n, 2))
    corner = np.c_[centres - (lx / 2, ly / 2), np.zeros(STREET_BOXES)][box]
    f = faces[face]
    samples = corner + f[:, 0] + uv[:, :1] * f[:, 1] + uv[:, 1:] * f[:, 2]
    points = np.concatenate([ground, samples]).astype(np.float32)
    source = np.concatenate([np.full(len(ground), -1), box]).astype(np.int32)
    return points, source


def dense_volume(tt, dev):
    """Phase 27's volume: bench.py's wavy frame fused at 256^3."""
    depth, intr = (torch.from_numpy(x).to(dev) for x in (wavy_depth(), DEPTH_INTR))
    return tt.tsdf_integrate(tt.create_tsdf_volume((TSDF_RES,) * 3, TSDF_VOXEL,
                                                   origin=TSDF_ORIGIN, device=dev),
                             depth, intr, torch.eye(4, device=dev))


def welded_mesh(tt, dev):
    """Phase 34's mesh: phase 27's volume through ``marching_cubes`` at
    iso 0 (the device weld)."""
    vol = dense_volume(tt, dev)
    return tt.marching_cubes(tt.VolumetricGrid(vol.tsdf, vol.origin, vol.voxel_size), 0.0)


def plain_stl_weld(path):
    """A plain reading of a binary STL: each corner's coordinates rounded
    to 6 decimals as a key, the first corner of each key kept, in a dict.
    Returns the (T, 3, 3) corners of the welded triangles."""
    data = Path(path).read_bytes()
    n_tri = int(np.frombuffer(data, "<u4", 1, 80)[0])
    rec = np.frombuffer(data, np.dtype([("n", "<f4", (3,)), ("v", "<f4", (3, 3)),
                                        ("a", "<u2")]), n_tri, 84)
    flat = np.ascontiguousarray(rec["v"]).reshape(-1, 3)
    first = {}
    rep = np.empty(len(flat), np.int64)
    for i, key in enumerate(map(tuple, np.round(flat, 6).tolist())):
        rep[i] = first.setdefault(key, i)
    return flat[rep].reshape(-1, 3, 3), len(first)


def search_agreement(card, cpu, q: np.ndarray, db: np.ndarray, radius: float):
    """Phase 42's radius search on the sampled voxels against the CPU's:
    (share of queries with equal neighbour sets, largest |d²| difference
    on shared ids, count of differing ids that lie outside the rounding
    band: farther than STREET_D2_ULPS ulp of |q|² + |p|² from the radius²
    and from the d² of the query's last kept slot)."""
    same, worst, unexplained = 0, 0.0, 0
    for i in range(len(q)):
        a = dict(zip(card[0][i][card[2][i]].tolist(), card[1][i][card[2][i]].tolist()))
        b = dict(zip(cpu[0][i][cpu[2][i]].tolist(), cpu[1][i][cpu[2][i]].tolist()))
        same += a.keys() == b.keys()
        for j in a.keys() & b.keys():
            worst = max(worst, abs(a[j] ** 2 - b[j] ** 2))
        last = max(max(a.values(), default=0.0), max(b.values(), default=0.0)) ** 2
        for j in a.keys() ^ b.keys():
            d2 = float(((q[i].astype(np.float64) - db[j]) ** 2).sum())
            band = STREET_D2_ULPS * float(np.spacing(np.float32(
                (q[i].astype(np.float64) ** 2).sum() + (db[j].astype(np.float64) ** 2).sum())))
            unexplained += abs(d2 - radius ** 2) > band and abs(d2 - last) > band
    return same / len(q), worst, unexplained


def sorted_scan(dev):
    """Phase-3 inputs: the 1M scan padded to a multiple of 256 and
    Morton-sorted (pass A), its validity, the pass-B order and the
    pass-A permutation (each sorted column's original row), on the card."""
    from threecrate_tpu_torch.ops import morton
    from threecrate_tpu_torch.utils.padding import round_up

    pts = torch.from_numpy(scan(N_SCAN, 0)).to(dev)
    n_pad = round_up(N_SCAN, 256)
    p = torch.zeros((n_pad, 3), device=dev)
    p[:N_SCAN] = pts
    m = torch.zeros(n_pad, dtype=torch.bool, device=dev)
    m[:N_SCAN] = True
    perm = torch.sort(morton.morton_keys(p, m, 0), stable=True).indices
    pa, va = p[perm], m[perm]
    row_a = torch.sort(morton.morton_keys(pa, va, 1), stable=True).indices
    return pa, va.float(), row_a, perm


def icp_inputs(dev, n_extra: int, w_tiles: int = 3, tile: int = 128):
    """Phase-3 icp_match inputs as the static-sort ICP builds them: the
    target Morton-sorted with 2e19 sentinels on its invalid tail, the
    shifted source sorted in the target's lattice, per-tile windows from
    the tile-mean key."""
    from threecrate_tpu_torch.ops import morton
    from threecrate_tpu_torch.utils.padding import round_up

    n_pad = round_up(N_SCAN, tile)
    tgt = torch.zeros((n_pad, 3), device=dev)
    tgt[:N_SCAN] = torch.from_numpy(scan(N_SCAN, 0) + SHIFT).to(dev)
    tm = torch.zeros(n_pad, dtype=torch.bool, device=dev)
    tm[:N_SCAN] = True
    mn, scale = morton.frame(tgt, tm)
    keys, order = torch.sort(morton.keys_in_frame(tgt, tm, mn, scale), stable=True)
    tv = tm[order].float()
    coords = torch.where(tv[:, None] < 0.5, 2e19, tgt[order])
    g = torch.Generator(device="cpu").manual_seed(1)
    extra = torch.randn((n_extra, n_pad), generator=g).to(dev)
    tgt_packed = torch.cat([coords.T, tv[None], extra]).contiguous()
    src = tgt.clone()
    src[:N_SCAN] -= torch.from_numpy(SHIFT).to(dev)
    src_sorted = src[torch.sort(morton.keys_in_frame(src, tm, mn, scale),
                                stable=True).indices]
    reps = src_sorted.reshape(-1, tile, 3).mean(1)
    rep_keys = morton.keys_in_frame(reps, torch.ones(len(reps), dtype=torch.bool,
                                                     device=dev), mn, scale)
    blk = torch.clamp(torch.searchsorted(keys, rep_keys) // tile - (w_tiles - 1) // 2,
                      0, n_pad // tile - w_tiles).to(torch.int32)
    src_packed = torch.cat([src_sorted.T, torch.ones((1, n_pad), device=dev)])
    return src_packed.contiguous(), tgt_packed, blk


def icp_nearest(src, tgt, starts, tile: int, w_tiles: int):
    """(nearest d², number of window columns at it) of each source point
    of ``icp_match``'s inputs, in the plain version's d² order, chunked
    over source tiles."""
    ns, nt = src.shape[1], tgt.shape[1]
    m = torch.empty(ns, device=src.device)
    ties = torch.empty(ns, dtype=torch.int64, device=src.device)
    j = torch.arange(w_tiles * tile, device=src.device)
    for t0 in range(0, ns // tile, 256):
        t1 = min(t0 + 256, ns // tile)
        cols = starts[t0:t1, None].long() * tile + j
        inside = (cols >= 0) & (cols < nt)
        pay = torch.where(inside[None], tgt[0:3, cols.clamp(0, nt - 1)], 2e19)
        q = src[0:3, t0 * tile:t1 * tile].reshape(3, t1 - t0, tile)
        d = [pay[r][:, None, :] - q[r][:, :, None] for r in range(3)]
        s = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
        mm = s.amin(2)
        m[t0 * tile:t1 * tile] = mm.reshape(-1)
        ties[t0 * tile:t1 * tile] = (s == mm[..., None]).sum(2).reshape(-1)
    return m, ties


def registration_pair():
    """The 1M registration pair as numpy arrays: (source, target, R)."""
    tgt = scan(N_SCAN, 3)
    c, s = np.cos(REG_ANGLE), np.sin(REG_ANGLE)
    rot = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
    return (tgt @ rot.T + REG_SHIFT).astype(np.float32), tgt, rot


def fpfh_inputs(dev):
    """Phase-3 FPFH inputs: the registration target with the port's
    normals, Morton-sorted twice and packed as ``_fpfh_fused`` packs it,
    and the input row of each pass-A position."""
    from threecrate_tpu_torch.core import PointCloud
    from threecrate_tpu_torch.ops.features import fused_stage1_inputs
    from threecrate_tpu_torch.ops.normals import estimate_normals_detailed

    pc = PointCloud.from_numpy(scan(N_SCAN, 3), pad_multiple=FPFH_TILE, device=dev)
    nrm = estimate_normals_detailed(pc).normals
    pa, pb, row_a, perm_a = fused_stage1_inputs(pc.points, pc.mask, nrm, FPFH_TILE)
    return pa, pb, row_a.to(torch.int32)[None].contiguous(), perm_a


def stage2_inputs(pa, pb, pos_b, spfh_a, spfh_b):
    """The stage-2 packed rows of both passes, ``(37, N)`` [x, y, z, valid,
    spfh (33)], from the stage-1 outputs, as ``_fpfh_fused`` builds them."""
    inv_b = torch.argsort(pos_b[0].long())
    raw = spfh_a.T + spfh_b.T[inv_b]
    spfh = raw[:, :33] / raw[:, 33:].clamp_min(1.0)
    return (torch.cat([pa[0:4], spfh.T]).contiguous(),
            torch.cat([pb[0:4], spfh[pos_b[0].long()].T]).contiguous())


def band_warp_work(packed: torch.Tensor, band: int, r2: float, pos_row=None):
    """(selected pairs a query, drain rounds a warp, offsets a warp at
    which some lane selects) of a banded SPFH kernel on ``packed``: a
    warp serves 32 consecutive queries and drains its queue once per 32
    selected pairs; a one-query-a-thread sweep runs the pair body at each
    offset where any of its 32 lanes selects."""
    from threecrate_tpu_torch.kernels import fpfh

    n, step = packed.shape[1], 1 << 16
    pairs, rounds, offsets = 0, 0, 0
    for c0 in range(0, n, step):
        sel = fpfh.band_candidates(packed, c0, min(c0 + step, n), band,
                                   float(np.float32(r2)), 1e-12, pos_row)[4]
        warp = sel.view(-1, 32, sel.shape[1])
        pairs += int(sel.sum().item())
        rounds += int(((warp.sum((1, 2)) + 31) // 32).sum().item())
        offsets += int(warp.any(1).sum().item())
    return pairs / n, rounds / (n // 32), offsets / (n // 32)


def pose_error(t: np.ndarray, rot: np.ndarray):
    """(|R'R - I|max, |R't + t'|max) of a recovered src → tgt transform
    against the applied tgt → src motion (R, REG_SHIFT)."""
    return (float(np.abs(t[:3, :3] @ rot - np.eye(3)).max()),
            float(np.abs(t[:3, :3] @ REG_SHIFT + t[:3, 3]).max()))


def share(eq: torch.Tensor) -> float:
    """Share of True in a bool tensor, counted in integers (a float mean
    of ~1M ones on the card need not come out as exactly 1.0)."""
    return int(eq.sum().item()) / eq.numel()


def union_error(got: torch.Tensor, ref: torch.Tensor, valid: torch.Tensor):
    """(rows 0 and 10 bit-equal fraction, max relative sum error, max abs
    error) over valid queries."""
    g, r = got[:, valid], ref[:, valid]
    exact = share((g[0] == r[0]) & (g[10] == r[10]))
    tr = (r[4] + r[5] + r[6]).clamp_min(1e-30)
    scale = torch.cat([(tr * r[0].clamp_min(1)).sqrt().expand(3, -1), tr.expand(6, -1)])
    rel = ((g[1:10] - r[1:10]).abs() / scale).max().item()
    return exact, rel, (g - r).abs().max().item()


def knn_name(cname: str) -> str:
    """Timing name of a ``KNN_CONFIGS`` entry: ``knn_window`` for
    ``method="window"`` normals' k = 10, else ``knn_window <config>``."""
    return "knn_window" if cname == "k=10" else f"knn_window {cname}"


def open_columns(p: torch.Tensor, tile: int, thr, chunk_name: str, source: str = "fpfh.cu",
                 *, queries=None, col_ok=None, starts=None, w_tiles: int = 3):
    """(window columns, box tests) that a culled window sweep cannot skip
    on the rows ``p`` [x, y, z, valid, ...]: summed over the counted
    queries, the columns of each chunk of the query's window whose fp32
    box bound (``tc::chunk_beyond<false>``, shrunk by ``kCullMargin``)
    does not lie beyond the query's threshold ``thr`` (one float, or one
    per query), and one box test per chunk and query.

    Chunks hold ``chunk_name`` columns (read from ``csrc/<source>``), at
    most a tile (the FPFH kernels' rule; the others run here at tiles of
    at least a chunk). The window of query tile t is the ``w_tiles``
    tiles from ``starts[t]`` (default t - 1: prev/self/next); its columns
    outside ``p`` and those not ``col_ok`` (default: valid) are in no
    box. Every one of ``queries`` (3, Nq) counts; without them, p's valid
    points (the full-window FPFH kernels 6-9)."""
    csrc = Path(__file__).resolve().parent / "threecrate_tpu_torch" / "csrc"
    chunk = min(tile, int(re.search(rf"constexpr int {chunk_name} = (\d+);",
                                    (csrc / source).read_text()).group(1)))
    margin = 1.0 - 1.0 / float(re.search(r"kCullMargin = 1\.f - 1\.f / (\d+)\.f;",
                                         (csrc / "window.cuh").read_text()).group(1))
    dev, n = p.device, p.shape[1]
    xyz = p[0:3]
    col_ok = p[3] > 0.5 if col_ok is None else col_ok
    q = xyz if queries is None else queries
    q_ok = p[3] > 0.5 if queries is None else torch.ones(q.shape[1], dtype=torch.bool,
                                                         device=dev)
    n_t = q.shape[1] // tile
    starts = (torch.arange(n_t, device=dev) - 1 if starts is None else starts.long())
    wc = w_tiles * tile
    nch = -(-wc // chunk)
    j = torch.arange(nch * chunk, device=dev)
    width = (wc - torch.arange(nch, device=dev) * chunk).clamp(max=chunk)  # columns a chunk
    thr = torch.as_tensor(thr, dtype=torch.float32, device=dev).expand(q.shape[1])
    thr = thr.clamp_min(1e-30)
    inf, step, cols = float("inf"), 256, 0
    for t0 in range(0, n_t, step):
        t1 = min(t0 + step, n_t)
        c = starts[t0:t1, None] * tile + j
        cc = c.clamp(0, n - 1)
        ok = (c >= 0) & (c < n) & (j < wc) & col_ok[cc]
        w = xyz[:, cc]
        lo = torch.where(ok, w, inf).view(3, t1 - t0, nch, chunk).amin(3)[:, :, None]
        hi = torch.where(ok, w, -inf).view(3, t1 - t0, nch, chunk).amax(3)[:, :, None]
        qq = q[:, t0 * tile:t1 * tile].reshape(3, t1 - t0, tile, 1)
        gap = torch.maximum(lo - qq, qq - hi).clamp_min(0)
        lb = (gap[0] * gap[0] + gap[1] * gap[1] + gap[2] * gap[2]) * margin
        kept = ((lb <= thr[t0 * tile:t1 * tile].view(-1, tile, 1))
                & q_ok[t0 * tile:t1 * tile].view(-1, tile, 1))
        cols += (kept * width).sum().item()
    return cols, q_ok[:n_t * tile].sum().item() * nch


def icp_open_columns(src, tgt, starts, tile: int, w_tiles: int, nearest_d2):
    """``open_columns`` of ``icp_match``'s records body: every source
    point against its tile's window of ``w_tiles`` target tiles from
    ``starts``, threshold its final nearest d², boxes over the targets
    below the sentinel magnitude (``kFarTarget``)."""
    return open_columns(tgt, tile, nearest_d2, "kChunk", "window.cuh", queries=src[0:3],
                        col_ok=tgt[0:3].abs().amax(0) < 2e19, starts=starts, w_tiles=w_tiles)


def knn_open_columns(pts, valid, neg, tile: int):
    """``open_columns`` of ``knn_window``: every query against its 3-tile
    window, threshold the final k-th d² (row k - 1 of the plain -d²;
    +inf, every chunk open, where fewer than k candidates are finite)."""
    return open_columns(torch.cat([pts, valid]), tile, -neg[-1], "kChunk", "window.cuh",
                        queries=pts)


def knn_launch_key(shape) -> str:
    """Launch-count key of ``knn_window_tiles``' (k, with_coords,
    exclude_self) shape: ``knn_window <config>`` for each of
    ``KNN_CONFIGS``."""
    names = {tuple(v): cname for cname, v in KNN_CONFIGS.items()}
    return f"knn_window {names.get(tuple(shape), shape)}"


def bound(nbytes: float, ops: float):
    """(least ms the card could take, what bounds it) for a kernel that
    moves ``nbytes`` and does ``ops`` fp32 operations."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def union_window_ops(n_u, tile, band):
    """fp32 operations of a union pass's selection on ``n_u`` queries (see
    ``kernel_work``): each of the 3·tile window candidates' d² (~9), a
    compare with the current k-th (1) and the selection test (1), ~2 per
    ±band candidate, 12 per query for the six halvings."""
    return n_u * (3 * tile * (9 + 1 + 1) + (2 * band + 1) * 2 + 6 * 2)


def union_work(n_u, tile, band, pairs_a, pairs_b):
    """(bytes, fp32 operations) of union passes A and B at the band they
    run (max(band, k)) with ``pairs_a`` / ``pairs_b`` selected pairs."""
    ops = union_window_ops(n_u, tile, band)
    return ((4 * n_u * (4 + 11), ops + pairs_a * 19),
            (4 * n_u * (6 + 11), ops + n_u * 3 * tile * 3 + pairs_b * 19))


def kernel_work(n_u, tile, band, icp_args, n_f, pairs, windows):
    """(bytes, fp32 operations) of each timed kernel call on this run's
    inputs: the union passes and ``knn_window`` (each of ``KNN_SHAPES``)
    on ``n_u`` sorted scan points, ``icp_match`` on ``icp_args`` (E = 0),
    the FPFH, SHOT and union kernels on their points with ``pairs``
    selected candidates each (from their count rows), the full-window
    FPFH kernels, ``icp_match`` and ``knn_window`` examining the
    (columns, box tests) of ``windows`` (from ``open_columns``: no sweep
    order can pass over a chunk whose box bound lies at or below the
    query's final threshold, r2, the nearest d² or the k-th d²), and
    ``knn_window`` ~k·log2(k) operations a query to order its k slots
    (the merges). Operations per examined candidate and per
    selected pair are those of each source's note in csrc/: a distance
    test ~9, with the selection ~12; a pair's SPFH features ~100, its
    stage-2 weighting ~68, its SHOT moments ~30, its SHOT histogram vote
    ~55 (USC ~45). The union's radius depends only on the window's k-th
    smallest d² (Pallas' six counting rounds are six halvings against
    it), so its function needs each of the 3·tile window candidates' d²
    once (~9), a compare with the current k-th (1) and the final
    selection test (1), pass B the pass-A tile test (~3); ~2 per ±band
    candidate for the band radius, 12 per query for the six halvings,
    and ~19 per selected pair for the sums (3 differences, 6 products,
    10 additions). Kernel 4's band body computes the same radius."""
    src, tgt, starts = icp_args
    shot_c = 2 * SHOT_BAND + 1
    union_ops = union_window_ops(n_u, tile, band)
    work_a, work_b = union_work(n_u, tile, band, pairs["union_window_a"],
                                pairs["union_window_b"])
    k = 10     # window_normals' k
    work = {
        # the band body: union A's selection, ~19 per selected pair for the
        # moments, NORMALS_EIG_OPS per query; 16 bytes in and 24 out per query
        "window_normals": (4 * n_u * (4 + 6), union_ops + pairs["window_normals"] * 19
                           + n_u * NORMALS_EIG_OPS),
        # the exact body: each window candidate's d^2 and a compare with the
        # current k-th (10), k list insertions of ~k compare-selects, 19 per
        # selected pair, the eigensolve
        "window_normals band=0": (4 * n_u * (4 + 6), n_u * (3 * tile * 10 + k * k
                                                            + NORMALS_EIG_OPS)
                                  + pairs["window_normals band=0"] * 19),
        "union_window_a": work_a,
        "union_window_b": work_b,
        # each examined target's d^2 and a compare with the running minimum
        "icp_match": (4 * (src.numel() + tgt.numel() + starts.numel() + src.numel()),
                      windows["icp_match"][0] * 9 + windows["icp_match"][1] * BOX_TEST_OPS),
        # coordinates, validity and ids in; -d^2 and ids (and 3 coordinates)
        # out per slot; each examined candidate's d^2 and a compare with the
        # k-th
        **{knn_name(cname): (4 * n_u * 5 + 4 * n_u * kk * (5 if coords else 2),
                             windows[knn_name(cname)][0] * 9
                             + windows[knn_name(cname)][1] * BOX_TEST_OPS
                             + n_u * kk * math.log2(kk))
           for cname, (kk, coords, _) in KNN_SHAPES.items()},
        **{sname: (4 * n_f * ((8 if sname.startswith("spfh_b") else 7) + 34),
                   windows[sname][0] * 12 + windows[sname][1] * BOX_TEST_OPS
                   + pairs[sname] * 100) for sname in SPFH_RUNS},
        **{wname: (4 * n_f * ((38 if wname.startswith("fpfh_weight_b") else 37) + 34),
                   windows[wname][0] * 9 + windows[wname][1] * BOX_TEST_OPS
                   + pairs[wname] * 68) for wname in WEIGHT_RUNS},
        "spfh_band_a": (4 * n_f * (7 + 34), n_f * (2 * BAND + 1) * 12
                        + pairs["spfh_band_a"] * 100),
        "spfh_band_b": (4 * n_f * (8 + 34), n_f * (2 * BAND + 1) * 12
                        + pairs["spfh_band_b"] * 100),
        "shot_moments_a": (4 * n_f * (4 + 14), n_f * shot_c * 12
                           + pairs["shot_moments_a"] * 30),
        "shot_moments_b": (4 * n_f * (5 + 14), n_f * shot_c * 12
                           + pairs["shot_moments_b"] * 30),
        # placed: pass B reads the int32 row and writes a 64-byte row a
        # query; pass A reads a 64-byte row besides its own rows
        "shot_moments_b placed": (4 * n_f * (5 + 1) + 64 * n_f, n_f * shot_c * 12
                                  + pairs["shot_moments_b placed"] * 30),
        "shot_moments_a plus": (4 * n_f * (4 + 14) + 64 * n_f, n_f * shot_c * 12
                                + pairs["shot_moments_a plus"] * 30),
    }
    # the histograms: rows and frames in, dim + 1 floats out per query;
    # placed, the int32 row index in too, and where pass A adds, the row
    # it adds to read as well
    for kname, rows, mode, extra in (("shot_hist_a", 7 + 9, "", 0),
                                     ("shot_hist_b", 8 + 9, "", 0),
                                     ("shot_hist_b", 8 + 9, " placed", 1),
                                     ("shot_hist_a", 7 + 9, " add", 1)):
        for sfx, dim, per_pair in (("", 352, 55), (" usc", 128, 45)):
            read = dim + 1 if mode == " add" else 0
            work[kname + mode + sfx] = (4 * n_f * (rows + extra + read + dim + 1),
                                        n_f * shot_c * 12 + pairs[kname + mode + sfx]
                                        * per_pair)
    return work


def busy_time(fn) -> float:
    """Device busy ms of one call of ``fn`` under ``torch.profiler``
    (``utils.profiling.device_profile``): for host-bound calls, the part
    that the kernels can move."""
    from threecrate_tpu_torch.utils.profiling import device_profile

    return device_profile(fn)[1]


def host_syncs(fn, warmup: bool = True) -> int:
    """Host syncs in one call of ``fn`` (after a warm-up call unless
    ``warmup`` is false): the warnings that
    ``torch.cuda.set_sync_debug_mode("warn")`` raises in it."""
    if warmup:
        fn()
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return sum("synchroniz" in str(w.message) for w in caught)


def measure(fn, profile: bool = True) -> dict:
    """ms of ``fn`` (median of 3 after one warm-up, CUDA events), peak GiB,
    host syncs and, with ``profile``, device busy ms."""
    from threecrate_tpu_torch.utils.profiling import median_time

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ms = 1e3 * median_time(fn, warmup=1, iters=3)
    peak = torch.cuda.max_memory_allocated() / 2**30
    out = {"ms": ms, "peak_gib": peak, "host_syncs": host_syncs(fn)}
    if profile:
        out["busy_ms"] = busy_time(fn)
    return out


def run_counted(kernels, total, fn):
    """fn() with the launch counters reset just before and read just
    after; the counts are added to ``total``, ``knn_window``'s also by
    shape under ``knn_launch_key``."""
    kernels.reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    for kname, n in counts.items():
        total[kname] += n
    for shape, n in kernels.knn_window_tiles.shape_launches.items():
        total[knn_launch_key(shape)] = total.get(knn_launch_key(shape), 0) + n
    return out, counts


def only(counts, expected) -> bool:
    """True when exactly the kernels of ``expected`` launched, as often."""
    return all(counts[k] == expected.get(k, 0) for k in counts)


def shot_moment_inputs(pa, pb, pos_b):
    """The moment kernels' phase-3 inputs as ``_shot_fused`` builds them:
    ({kernel: packed rows}, the pass-A row of each pass-B position, int32)."""
    return ({"shot_moments_a": pa[0:4].contiguous(),
             "shot_moments_b": torch.cat([pb[0:4], pos_b.to(torch.float32)]).contiguous()},
            pos_b[0].contiguous())


def merged_moments(kind, packed, rows):
    """Pass B of the moments written at ``rows`` into a NaN-filled
    query-major buffer, then pass A adding it, through the ``kind``
    functions ("tiles" or "plain"): (pass B's buffer, the merged (14, N)
    rows in pass-A order), as ``_shot_fused`` merges them."""
    from threecrate_tpu_torch.kernels import shot

    geom = (SHOT_RADIUS * SHOT_RADIUS, SHOT_BAND, FPFH_TILE)
    buf = torch.full((rows.shape[0], shot.MOMENT_ROW), float("nan"), device=rows.device)
    getattr(shot, f"shot_moments_b_{kind}")(packed["shot_moments_b"], *geom, out=buf,
                                            rows=rows)
    return buf, getattr(shot, f"shot_moments_a_{kind}")(packed["shot_moments_a"], *geom,
                                                        plus=buf)


def shot_hist_inputs(pa, pb, pos_b, perm_a, mom):
    """The histogram kernels' phase-3 inputs as ``_shot_fused`` builds
    them from the merged moment rows ``mom`` (14, N): ({kernel: (packed,
    frames)}, {kernel: the input row of each of its positions, int32})."""
    from threecrate_tpu_torch.ops.features import lrf_from_moments

    row_a = pos_b[0].long()
    lrf = lrf_from_moments(mom.T, SHOT_RADIUS, pa[4:7].T)
    rows_a = perm_a.to(torch.int32)
    return ({"shot_hist_a": (pa, lrf.T.contiguous()),
             "shot_hist_b": (torch.cat([pb, pos_b.to(torch.float32)]).contiguous(),
                             lrf[row_a].T.contiguous())},
            {"shot_hist_a": rows_a, "shot_hist_b": rows_a[row_a]})


def hist_agreement(got, ref, dim):
    """(count column bit-equal, share of queries with every float
    bit-equal, max vote error / count) of query-major histogram rows."""
    vote = ((got[:, :dim] - ref[:, :dim]).abs().amax(1) / ref[:, dim].clamp_min(1)).max()
    return torch.equal(got[:, dim], ref[:, dim]), share((got == ref).all(1)), vote.item()


def moment_agreement(got, ref):
    """(count row bit-equal, max sum error / Σw·R^k) of (14, N) moment rows."""
    radius = float(np.float32(SHOT_RADIUS))
    power = torch.tensor([0, 1, 1, 1, 2, 2, 2, 2, 2, 2, 0, 3, 3, 3], device=ref.device)
    scale = ref[0].clamp_min(1e-30)[None] * radius ** power[:, None]
    return torch.equal(got[10], ref[10]), ((got - ref).abs() / scale).max().item()


def shot_kernel_checks(pa, pb, pos_b, perm_a):
    """Phase 3, SHOT/USC kernels on the registration target's sorted rows
    (r = 0.25, band 32, tile 256): each against its plain version, the
    moments standalone and placed as ``_shot_fused`` merges them (pass B
    written at each position's pass-A row, pass A adding it), the
    histograms in both variants on one set of frames built from the
    plain merged moments, standalone (rows p of a new buffer) and placed
    as ``_shot_fused`` places them (pass B written at each position's
    input row, then pass A added at its own); each twice (the same bits).
    Returns ({timing name: (kernel call, plain call)}, max abs error and
    selected pairs by timing name)."""
    from threecrate_tpu_torch.kernels import shot

    r2 = SHOT_RADIUS * SHOT_RADIUS
    geom = (r2, SHOT_BAND, FPFH_TILE)
    calls, err, pairs, mom = {}, {}, {}, {}
    packed, rows_m = shot_moment_inputs(pa, pb, pos_b)
    for kname, args in packed.items():
        kern, plain = getattr(shot, kname + "_tiles"), getattr(shot, kname + "_plain")
        got, again, ref = kern(args, *geom), kern(args, *geom), plain(args, *geom)
        torch.cuda.synchronize()
        cnt_eq, rel = moment_agreement(got, ref)
        same = torch.equal(got, again)
        err[kname], pairs[kname] = (got - ref).abs().max().item(), ref[10].sum().item()
        log(f"  {kname}: N={pa.shape[1]} r={SHOT_RADIUS} band={SHOT_BAND} count row "
            f"bit-equal {cnt_eq} (need True), sums max err / Σw·R^k {rel:.3e} (tol "
            f"{SHOT_REL_TOL}), max abs err {err[kname]:.3e}, two calls bit-equal {same} "
            f"(need True), mean count {pairs[kname] / pa.shape[1]:.2f}")
        check(cnt_eq and rel <= SHOT_REL_TOL and same, f"{kname} disagrees")
        calls[kname] = (lambda kern=kern, a=args: kern(a, *geom),
                        lambda plain=plain, a=args: plain(a, *geom))
        mom[kname] = ref
    # placed: pass B at each position's pass-A row, pass A adding it; the
    # plain merge against the gathered sum it replaces
    merged = {side: merged_moments(side.split()[0], packed, rows_m)
              for side in ("tiles", "plain", "tiles again")}
    torch.cuda.synchronize()
    gathered = (mom["shot_moments_a"].T
                + mom["shot_moments_b"].T[torch.argsort(rows_m.long())]).T
    del mom
    for tname, i in (("shot_moments_b placed", 0), ("shot_moments_a plus", 1)):
        got, again, ref = (merged[side][i] for side in ("tiles", "tiles again", "plain"))
        if i == 0:      # every row written, the two pads zero, sums as (14, N) rows
            written = bool(torch.isfinite(got).all()) and bool((got[:, 14:] == 0).all())
            got, again, ref = (t[:, :14].T for t in (got, again, ref))
        else:
            written = torch.equal(ref, gathered)
        cnt_eq, rel = moment_agreement(got, ref)
        cnt_g, rel_g = moment_agreement(got, gathered)
        same = torch.equal(got, again)
        err[tname] = (got - ref).abs().max().item()
        pairs[tname] = pairs[tname.split()[0]]
        log(f"  {tname}: count row bit-equal {cnt_eq} (need True), sums max err / Σw·R^k "
            f"{rel:.3e} (tol {SHOT_REL_TOL}), max abs err {err[tname]:.3e}, two calls "
            f"bit-equal {same} (need True); "
            + (f"every row written with zero pads {written} (need True)" if i == 0 else
               f"plain placed merge bit-equal to mom_a.T + mom_b.T[argsort(row_a)] "
               f"{written} (need True), kernel against that sum: count row bit-equal "
               f"{cnt_g} (need True), sums max err / Σw·R^k {rel_g:.3e}"))
        check(cnt_eq and rel <= SHOT_REL_TOL and same and written
              and (i == 0 or (cnt_g and rel_g <= SHOT_REL_TOL)), f"{tname} disagrees")

    def placed_call(tname, side):
        """The timed call of a placed mode, on the buffer its side placed."""
        buf = merged[side][0]
        if tname == "shot_moments_b placed":
            fn = getattr(shot, f"shot_moments_b_{side}")
            return lambda: fn(packed["shot_moments_b"], *geom, out=buf, rows=rows_m)
        fn = getattr(shot, f"shot_moments_a_{side}")
        return lambda: fn(packed["shot_moments_a"], *geom, plus=buf)

    for tname in ("shot_moments_b placed", "shot_moments_a plus"):
        calls[tname] = (placed_call(tname, "tiles"), placed_call(tname, "plain"))
    hist_args, rows = shot_hist_inputs(pa, pb, pos_b, perm_a, merged["plain"][1])
    del merged, gathered
    n = pa.shape[1]
    buf = {}      # the timed placed calls' buffers, by variant

    def agree(tname, got, again, ref, dim):
        cnt_eq, exact, vote = hist_agreement(got, ref, dim)
        same = torch.equal(got, again)
        err[tname] = (got - ref).abs().max().item()
        log(f"  {tname}: count column bit-equal {cnt_eq} (need True), all {dim + 1} "
            f"floats bit-equal on {exact:.6f} of queries (USC: need 1), max vote err / "
            f"count {vote:.3e} (SHOT: tol {SHOT_REL_TOL}), max abs err {err[tname]:.3e}, "
            f"two calls bit-equal {same} (need True)")
        check(cnt_eq and same and (exact == 1.0 if dim == 128 else vote <= SHOT_REL_TOL),
              f"{tname} disagrees")

    for variant, dim in (("shot", 352), ("usc", 128)):
        sfx = "" if variant == "shot" else " usc"
        for kname, args in hist_args.items():
            kern, plain = getattr(shot, kname + "_tiles"), getattr(shot, kname + "_plain")
            got, again = kern(*args, *geom, variant), kern(*args, *geom, variant)
            ref = plain(*args, *geom, variant)
            torch.cuda.synchronize()
            pairs[kname + sfx] = ref[dim].sum().item()
            agree(kname + sfx, got.T, again.T, ref.T, dim)
            calls[kname + sfx] = (lambda kern=kern, a=args, v=variant: kern(*a, *geom, v),
                                  lambda plain=plain, a=args, v=variant: plain(*a, *geom, v))
        # placed: pass B written at its input rows, pass A added at its own
        placed = {}
        for side in ("tiles", "plain", "tiles again"):
            out = torch.full((n, dim + 1), float("nan"), device=pa.device)
            for kname, acc in (("shot_hist_b", False), ("shot_hist_a", True)):
                fn = getattr(shot, f"{kname}_{side.split()[0]}")
                fn(*hist_args[kname], *geom, variant, out=out, rows=rows[kname],
                   accumulate=acc)
                if kname == "shot_hist_b":
                    placed[side, "b"] = out.clone()
            placed[side, "a"] = out
        torch.cuda.synchronize()
        buf[variant] = placed["tiles", "a"]
        for kname, tname, pass_ in (("shot_hist_b", f"shot_hist_b placed{sfx}", "b"),
                                    ("shot_hist_a", f"shot_hist_a add{sfx}", "a")):
            agree(tname, placed["tiles", pass_], placed["tiles again", pass_],
                  placed["plain", pass_], dim)
            pairs[tname] = pairs[kname + sfx]
            kern, plain = getattr(shot, kname + "_tiles"), getattr(shot, kname + "_plain")
            calls[tname] = tuple(
                lambda fn=fn, k=kname, v=variant, acc=pass_ == "a": fn(
                    *hist_args[k], *geom, v, out=buf[v], rows=rows[k], accumulate=acc)
                for fn in (kern, plain))
        del placed
    return calls, err, pairs


def union_k_checks(pts_a, valid_a, row_a, tile: int, band: int, k: int):
    """Phase 3 at another k of the main path: both union passes at ``k``
    (GICP's 20, the band widened from ``band`` to k, the KMAX = 32
    instantiation; the analysis's 8, inside the band) on the sorted 1M
    scan against their plain versions, count and radius (use_b)
    bit-equal, sums within SUM_REL_TOL. Returns ({timing name: (kernel
    call, plain ms of the one checked call)}, {name: max abs error},
    (selected pairs of A, of B))."""
    from threecrate_tpu_torch.kernels.knn import (window_union_a_plain, window_union_a_tiles,
                                                  window_union_b_plain, window_union_b_tiles)

    def plain_once(fn):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        end.synchronize()
        return out, start.elapsed_time(end)

    va = valid_a[0] > 0.5
    a_in = (pts_a, valid_a, k, tile, band)
    out_a = window_union_a_tiles(*a_in)
    ref_a, plain_a = plain_once(lambda: window_union_a_plain(*a_in))
    ea = union_error(out_a, ref_a, va)
    b_in = (pts_a[:, row_a].contiguous(), valid_a[:, row_a].contiguous(),
            row_a.to(torch.int32)[None].contiguous(), out_a[10][row_a][None].contiguous(),
            k, tile, band)
    out_b = window_union_b_tiles(*b_in)
    ref_b, plain_b = plain_once(lambda: window_union_b_plain(*b_in))
    eb = union_error(out_b, ref_b, b_in[1][0] > 0.5)
    for kname, e in (("union_window_a", ea), ("union_window_b", eb)):
        row = "radius" if kname.endswith("a") else "use_b"
        log(f"  {kname} k={k} band {band}->{max(band, k)}: cnt+{row} bit-equal "
            f"{e[0]:.6f} (need 1), sums max rel err {e[1]:.3e} (tol {SUM_REL_TOL}), max abs "
            f"err {e[2]:.3e}")
        check(e[0] == 1.0 and e[1] <= SUM_REL_TOL, f"{kname} k={k} disagrees")
    calls = {f"union_window_a k={k}": (lambda: window_union_a_tiles(*a_in), plain_a),
             f"union_window_b k={k}": (lambda: window_union_b_tiles(*b_in), plain_b)}
    errs = {f"union_window_a k={k}": ea[2], f"union_window_b k={k}": eb[2]}
    return calls, errs, (ref_a[0].sum().item(), ref_b[0].sum().item())


def normals_kernel_checks(pts, valid, k, tile):
    """Phase 3, ``window_normals_tiles`` at each of ``NORMALS_BANDS`` on the
    sorted 1M scan against its plain version. Returns (max abs error of
    the normal and curvature rows over valid queries, selected pairs by
    timing name)."""
    from threecrate_tpu_torch.kernels.knn import window_normals_plain, window_normals_tiles

    v = valid[0] > 0.5
    err, pairs = 0.0, {}
    for tname, band in NORMALS_BANDS.items():
        got = window_normals_tiles(pts, valid, k, tile, band)
        ref = window_normals_plain(pts, valid, k, tile, band)
        torch.cuda.synchronize()
        sel_eq = torch.equal(got[4], ref[4]) and torch.equal(got[5], ref[5])
        g, r = got[:, v], ref[:, v]
        equal = share((g == r).all(0))
        dev_n = (g[:4] - r[:4]).abs().amax(0)
        close = share(dev_n <= NORMALS_ABS_TOL)
        err = max(err, dev_n.max().item())
        pairs[tname] = r[4].sum().item()
        log(f"  {tname}: N={pts.shape[1]} k={k} band={band} count+k-th rows bit-equal "
            f"{sel_eq} (need True), all 6 rows bit-equal on {equal:.7f} of valid queries "
            f"(need >= {NORMALS_EQUAL_SHARE}), normal/curvature within {NORMALS_ABS_TOL} "
            f"on {close:.7f}, max abs err {dev_n.max().item():.3e}, mean count "
            f"{r[4].mean().item():.3f}")
        check(sel_eq and equal >= NORMALS_EQUAL_SHARE and close >= NORMALS_EQUAL_SHARE,
              f"{tname} disagrees")
    return err, pairs


def exact_shot(points, mask, nrm, sub, variant):
    """Staged SHOT/USC descriptors ``(desc, valid, neighbours)`` of the
    rows ``sub`` over an exact radius search (r = 0.25, up to 128
    neighbours, self excluded): ``neighbors.knn`` candidates, distances
    recomputed as direct differences (its d² expands |q|² + |p|² − 2q·p,
    ~1e-3 m² off at 100 m), the nearest 128 kept."""
    from threecrate_tpu_torch.ops import neighbors
    from threecrate_tpu_torch.ops.features import _shot_descriptor_block

    radius = float(np.float32(SHOT_RADIUS))
    q = points[sub]
    cand = neighbors.knn(points, mask, q, mask[sub], SHOT_MAX_NEIGHBORS + 1)
    d = (points[cand.indices] - q[:, None]).norm(dim=-1)
    d = torch.where(cand.mask & (cand.indices != sub[:, None]), d, torch.inf)
    d, order = torch.sort(d, dim=1)
    idx = torch.gather(cand.indices, 1, order)[:, :SHOT_MAX_NEIGHBORS]
    d = d[:, :SHOT_MAX_NEIGHBORS]
    ok = d <= radius
    desc = _shot_descriptor_block(points[idx], nrm[idx], ok, d, q, nrm[sub], radius, 11,
                                  variant)
    cnt = ok.sum(1)
    return desc, mask[sub] & (cnt >= 5), cnt


def fused_counts(points, mask):
    """In-radius candidates the fused SHOT path sees for each point (its
    two ±band windows, pass A and pass B), in input order, from the plain
    moment passes."""
    from threecrate_tpu_torch.kernels import shot
    from threecrate_tpu_torch.ops.features import fused_stage1_inputs

    r2 = SHOT_RADIUS * SHOT_RADIUS
    pa, pb, row_a, perm_a = fused_stage1_inputs(points, mask, torch.zeros_like(points),
                                                FPFH_TILE)
    cnt = shot.shot_moments_a_plain(pa[0:4].contiguous(), r2, SHOT_BAND, FPFH_TILE)[10]
    cnt[row_a] += shot.shot_moments_b_plain(
        torch.cat([pb[0:4], row_a.to(torch.float32)[None]]).contiguous(), r2, SHOT_BAND,
        FPFH_TILE)[10]
    out = torch.empty_like(cnt)
    out[perm_a] = cnt
    return out[:points.shape[0]]


def root_surface_phases(dev, kernels):
    """Phases 52-54: the user-facing surface. The root names (``compat``'s
    adapters and ``api``'s helpers) take NumPy arrays, which land on the
    card; each is held against the native call on a cloud built on the
    card, and its time is logged beside that call's. Then the debug and
    profiling hooks, and ``viz`` at full width against the port's CPU run.
    Returns (launches of the root names' and the viewer's runs, numbers
    for the log)."""
    import threecrate_tpu_torch as tt
    from threecrate_tpu_torch import prelude
    from threecrate_tpu_torch.models import PerceptionStep
    from threecrate_tpu_torch.ops import features, filtering, normals, registration
    from threecrate_tpu_torch.ops import global_registration as greg
    from threecrate_tpu_torch.utils import debug, profiling
    from threecrate_tpu_torch.utils.profiling import device_profile, median_time
    from threecrate_tpu_torch.viz import InteractiveViewer
    from threecrate_tpu_torch.viz import renderer as tr

    total = dict.fromkeys(kernels.WRAPPERS, 0)
    report = {"card": card_line()}
    cpu = torch.device("cpu")
    t_phase = time.perf_counter()

    def phase_seconds():
        nonlocal t_phase
        t, t_phase = time.perf_counter() - t_phase, time.perf_counter()
        return f"{t:.1f} s"

    def counted(fn, expect):
        """fn() with the launch counters reset just before: its output and
        launches, checked to be exactly ``expect``."""
        out, counts = run_counted(kernels, total, fn)
        check(only(counts, expect), f"launches {dict(counts)}, expected exactly {expect}")
        return out, {k: n for k, n in counts.items() if n}

    def side_by_side(name, adapter, native, iters=3):
        """The adapter's and the native call's ms (CUDA-event medians, warm)."""
        a = 1e3 * median_time(adapter, warmup=1, iters=iters)
        b = 1e3 * median_time(native, warmup=0, iters=iters)
        log(f"  {name}: adapter {a:.2f} ms, native {b:.2f} ms, difference {a - b:.2f} ms "
            f"({report['card']})")
        report.setdefault("adapter_ms", {})[name] = {"adapter": a, "native": b}

    def once(fn):
        """One more (warm) call of ``fn`` under ``torch.profiler`` (CUDA
        activity only) with ``torch.cuda.set_sync_debug_mode("warn")``: wall
        ms (host clock around it and a synchronise), device busy ms, peak
        GiB and the host syncs counted in that call."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        caught = []

        def traced():
            with warnings.catch_warnings(record=True) as got:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    fn()
                finally:
                    torch.cuda.set_sync_debug_mode("default")
                    caught.extend(got)

        wall, busy, _ = device_profile(traced, warmup=0)
        peak = torch.cuda.max_memory_allocated() / 2**30
        return {"ms": wall, "busy_ms": busy, "peak_gib": peak,
                "host_syncs": sum("synchroniz" in str(w.message) for w in caught)}

    def fmt(m):
        return (f"{m['ms']:.1f} ms, device busy {m['busy_ms']:.1f} ms (idle share "
                f"{1 - m['busy_ms'] / m['ms']:.3f}), peak {m['peak_gib']:.3f} GiB, "
                f"{m['host_syncs']} host syncs")

    # -- phase 52 -----------------------------------------------------------
    log(f"phase 52: the root names on {N_ROOT:,} points of scan({N_ROOT}, {ROOT_SEED}) "
        f"passed as NumPy arrays ({report['card']}, SM clock {sm_clock()})")
    p = scan(N_ROOT, ROOT_SEED)
    cloud = tt.PointCloud.from_numpy(p, device=dev)
    union = {"union_window_a": 1, "union_window_b": 1}
    for kw, k in (({}, 10), ({"k_neighbors": 8}, 8)):
        got, counts = counted(lambda: tt.estimate_normals(p, **kw), union)
        ref = normals.estimate_normals(tt.PointCloud.from_numpy(p, device=dev), k)
        same = torch.equal(got.normals, ref.normals) and torch.equal(got.mask, ref.mask)
        log(f"  estimate_normals(p{', k_neighbors=8' if kw else ''}): on {got.device}, launches "
            f"{counts}, normals bit-equal to the native call {same}")
        check(got.device.type == "cuda" and same, "estimate_normals(array) disagrees")
        side_by_side(f"estimate_normals k={k}", lambda: tt.estimate_normals(p, **kw),
                     lambda: normals.estimate_normals(tt.PointCloud.from_numpy(p, device=dev),
                                                      k))
    del got, ref

    src, tgt = p, p + SHIFT
    m4 = np.eye(4, dtype=np.float32)
    m4[:3, 3] = 0.5 * SHIFT
    res, counts = run_counted(kernels, total, lambda: tt.icp(src, tgt, 30, init_transform=m4))
    nat = registration.icp_point_to_point(
        tt.PointCloud.from_numpy(src, device=dev), tt.PointCloud.from_numpy(tgt, device=dev),
        30, init=tt.Transform.from_matrix(m4))
    t_icp = res.transformation()
    same = np.array_equal(t_icp, nat.transformation.cpu().numpy())
    err = float(np.abs(t_icp[:3, 3] - SHIFT).max())
    kind = type(res.transformation).__name__
    log(f"  icp(src, tgt, 30, init_transform=m4): {res.iterations} iterations, launches "
        f"{ {k: n for k, n in counts.items() if n} }, callable 4x4 {kind}, equal to the "
        f"native call {same}, shift within {err:.2e} m")
    check(only(counts, {"icp_match": res.iterations}) and same and err <= 1e-3
          and isinstance(res.transformation, np.ndarray), "icp(arrays, init_transform) failed")
    side_by_side("icp", lambda: tt.icp(src, tgt, 30, init_transform=m4),
                 lambda: registration.icp_point_to_point(
                     tt.PointCloud.from_numpy(src, device=dev),
                     tt.PointCloud.from_numpy(tgt, device=dev), 30,
                     init=tt.Transform.from_matrix(m4)))

    fpfh_expect = {**union, "spfh_band_a": 1, "spfh_band_b": 1, "fpfh_weight_a": 1,
                   "fpfh_weight_b": 1}
    feats, counts = counted(lambda: tt.extract_fpfh_features(cloud, 0.25, 10), fpfh_expect)
    nat = features.extract_fpfh_features(cloud, features.FpfhConfig(radius=0.25), k_normals=10)
    ref = nat.descriptors[cloud.mask].cpu().numpy()
    scale = np.maximum(np.abs(ref).sum(1, keepdims=True), 1.0)
    rel = float((np.abs(feats - ref) / scale).max())
    log(f"  extract_fpfh_features(cloud, 0.25, 10): {type(feats).__name__} {feats.shape} "
        f"{feats.dtype}, launches {counts}; against the native descriptors' valid rows: "
        f"bit-equal {np.array_equal(feats, ref)}, max |diff| / row scale {rel:.2e} (need <= "
        f"{FPFH_REL_TOL})")
    check(isinstance(feats, np.ndarray) and feats.shape == (N_ROOT, 33) and rel <= FPFH_REL_TOL,
          "extract_fpfh_features(reference convention) disagrees")
    side_by_side("extract_fpfh_features", lambda: tt.extract_fpfh_features(cloud, 0.25, 10),
                 lambda: features.extract_fpfh_features(cloud, features.FpfhConfig(radius=0.25),
                                                        k_normals=10))
    del feats, nat, ref

    rs, rt, rot = registration_pair()
    ref_args = (REG_CONFIG["ransac_iterations"], REG_CONFIG["distance_threshold"], 0.25,
                FPFH_RADIUS, 10, 10, True, 30)
    res, counts = run_counted(kernels, total, lambda: tt.global_registration(rs, rt, *ref_args))
    cfg = greg.GlobalRegistrationConfig(
        ransac_iterations=ref_args[0], distance_threshold=ref_args[1], inlier_ratio=0.25,
        fpfh_radius=FPFH_RADIUS, k_normals=10, refine_with_icp=True, icp_max_iterations=30)
    nat = greg.global_registration(tt.PointCloud.from_numpy(rs, device=dev),
                                   tt.PointCloud.from_numpy(rt, device=dev), cfg)
    t_g = res.transformation()
    r_err, t_err = pose_error(t_g, rot)
    nat_diff = float(np.abs(t_g - nat.transformation.cpu().numpy()).max())
    log(f"  global_registration(src, tgt, {', '.join(map(str, ref_args))}): launches "
        f"{ {k: n for k, n in counts.items() if n} }; |R'R - I| {r_err:.3e} (tol 1e-3), "
        f"|R't + t'| {t_err:.3e} m (tol 1e-2); native call's pose within {nat_diff:.2e}")
    check(r_err <= 1e-3 and t_err <= 1e-2 and nat_diff <= 1e-5,
          "global_registration (reference convention) missed the pose")
    check(all(counts[k] == 2 for k in ("union_window_a", "union_window_b", "spfh_a", "spfh_b",
                                       "fpfh_weight_a", "fpfh_weight_b"))
          and counts["icp_match"] >= 1 and counts["match_nearest"] == 2
          and not any(counts[k] for k in BAND_KERNELS + ("knn_window",)),
          "global_registration launched other kernels than its own")
    side_by_side("global_registration", lambda: tt.global_registration(rs, rt, *ref_args),
                 lambda: greg.global_registration(tt.PointCloud.from_numpy(rs, device=dev),
                                                  tt.PointCloud.from_numpy(rt, device=dev),
                                                  cfg), iters=1)
    report["phase52"] = {"global_registration": {"rot_err": r_err, "trans_err_m": t_err,
                                                 "native_diff": nat_diff}}
    del rs, rt

    sv, sf = uv_sphere(SIMPLIFY_SUB)
    sphere = tt.TriangleMesh.from_numpy(sv, sf, device=dev)
    simp, counts = counted(lambda: tt.simplify_mesh(sphere, 0.5), {})
    n_simp = int(simp.face_count())
    log(f"  simplify_mesh(mesh, 0.5) on a {len(sf):,}-face UV sphere: {n_simp:,} faces (need "
        f"{round(len(sf) * 0.5):,}), on {simp.vertices.device}")
    check(n_simp == round(len(sf) * 0.5) and simp.vertices.device.type == "cuda",
          "simplify_mesh(ratio) missed its face count")

    kept, counts = run_counted(kernels, total, lambda: tt.remove_statistical_outliers(p))
    nat = filtering.statistical_outlier_removal(cloud, 20, 2.0)
    same = torch.equal(kept.mask, nat.cloud.mask)
    log(f"  remove_statistical_outliers(p): kept {int(kept.mask.sum()):,} of {N_ROOT:,}, "
        f"launches { {k: n for k, n in counts.items() if n} }, mask equal to the native "
        f"call's {same}")
    check(counts["knn_window"] >= 1 and same and kept.device.type == "cuda",
          "remove_statistical_outliers(array) disagrees or skipped the window kernel")
    side_by_side("remove_statistical_outliers", lambda: tt.remove_statistical_outliers(p),
                 lambda: filtering.statistical_outlier_removal(
                     tt.PointCloud.from_numpy(p, device=dev), 20, 2.0))
    down, _ = counted(lambda: tt.voxel_downsample(p, 0.05), {})
    ref = tt.voxel_grid_filter(tt.PointCloud.from_numpy(p, device=dev), 0.05)
    moved, _ = counted(lambda: tt.transform_point_cloud(p, m4), {})
    mref = tt.PointCloud.from_numpy(p, device=dev).transform(tt.Transform.from_matrix(m4))
    same = (torch.equal(down.points, ref.points) and torch.equal(down.mask, ref.mask),
            torch.equal(moved.points, mref.points))
    log(f"  voxel_downsample(p, 0.05): {len(down):,} voxels, bit-equal to voxel_grid_filter "
        f"{same[0]}; transform_point_cloud(p, m4) bit-equal to PointCloud.transform {same[1]}")
    check(all(same), "voxel_downsample or transform_point_cloud disagrees")
    side_by_side("voxel_downsample", lambda: tt.voxel_downsample(p, 0.05),
                 lambda: tt.voxel_grid_filter(tt.PointCloud.from_numpy(p, device=dev), 0.05))
    side_by_side("transform_point_cloud", lambda: tt.transform_point_cloud(p, m4),
                 lambda: tt.PointCloud.from_numpy(p, device=dev).transform(
                     tt.Transform.from_matrix(m4)))
    missing = [n for n in prelude.__all__ if getattr(prelude, n) is not getattr(tt, n)]
    log(f"  prelude: {len(prelude.__all__)} names, all the root's objects {not missing}")
    check(len(prelude.__all__) == 33 and not missing, f"prelude names differ: {missing}")
    del down, ref, moved, mref, kept, nat, simp, sphere
    log(f"  phase {phase_seconds()}")

    # -- phase 53 -----------------------------------------------------------
    log("phase 53: utils.profiling.trace, median_time(sync_fn=...) and utils.debug.nan_checks "
        "on the card")
    ps, pt = scan(N_SCAN, 0), scan(N_SCAN, 0) + SHIFT
    pmask = np.ones(N_SCAN, bool)
    step = PerceptionStep()
    step(ps, pmask, pt, pmask)
    log_dir = Path(__file__).resolve().parent / "build" / "trace53"
    with profiling.trace(log_dir=str(log_dir)) as got_dir:
        step(ps, pmask, pt, pmask)
        torch.cuda.synchronize()
    files = sorted(log_dir.glob("*.pt.trace.json"))
    names = set()
    for f in files:
        names |= {e.get("name", "") for e in json.loads(f.read_text())["traceEvents"]
                  if e.get("cat") == "kernel"}
    union_k = sorted(n for n in names if "union" in n.lower())
    icp_k = sorted(n for n in names if "icp_match" in n.lower())
    log(f"  trace(log_dir) yielded {got_dir == str(log_dir)}, wrote {[f.name for f in files]}; "
        f"{len(names)} kernel names, the union kernels {union_k[:2]}, icp_match {icp_k[:2]}")
    check(got_dir == str(log_dir) and files and union_k and icp_k,
          "trace wrote no trace naming the union and ICP kernels")
    synced = []
    t_sync = median_time(lambda: step(ps, pmask, pt, pmask), warmup=1, iters=3,
                         sync_fn=lambda out: synced.append(profiling.sync(out)))
    log(f"  median_time(step, sync_fn=...): {1e3 * t_sync:.2f} ms, sync_fn called "
        f"{len(synced)} times (need 4: 1 warm-up + 3 runs)")
    check(len(synced) == 4 and t_sync > 0, "median_time did not apply sync_fn to each result")
    raised = False
    try:
        with debug.nan_checks():
            torch.zeros(1, device=dev) / torch.zeros(1, device=dev)
    except FloatingPointError:
        raised = True
    from torch.utils._python_dispatch import _get_current_dispatch_mode
    check(raised and _get_current_dispatch_mode() is None,
          "nan_checks did not raise on a NaN on the card")

    def checked_step():
        with debug.nan_checks():
            return step(ps, pmask, pt, pmask)

    plain_ms = 1e3 * median_time(lambda: step(ps, pmask, pt, pmask), warmup=1, iters=3)
    checked_ms = 1e3 * median_time(checked_step, warmup=1, iters=3)
    log(f"  nan_checks raised FloatingPointError on a CUDA 0/0 {raised}; PerceptionStep "
        f"{plain_ms:.2f} ms, under nan_checks {checked_ms:.2f} ms (+{checked_ms - plain_ms:.2f} "
        f"ms, clean: no raise) ({report['card']})")
    report["phase53"] = {"step_ms": plain_ms, "nan_checked_step_ms": checked_ms,
                         "median_time_sync_fn_ms": 1e3 * t_sync}
    del step, ps, pt
    log(f"  phase {phase_seconds()}")

    # -- phase 54 -----------------------------------------------------------
    log(f"phase 54: viz at full width ({report['card']}, SM clock {sm_clock()})")
    host = tt.PointCloud.from_numpy(p, device=cpu)
    renders = {}
    for w, h in RENDER_SIZES:
        img, counts = counted(lambda: tr.render_point_cloud(cloud, width=w, height=h,
                                                            point_size=2), {})
        ref = tr.render_point_cloud(host, width=w, height=h, point_size=2)
        d = np.abs(img - ref).max(-1)
        close = float((d <= RENDER_PIXEL_TOL).mean())
        coverage = float((np.abs(ref - np.float32(tr.BACKGROUND)).max(-1) > 0.02).mean())
        nums = once(lambda: tr.render_point_cloud(cloud, width=w, height=h, point_size=2))
        renders[f"points {w}x{h}"] = {**nums, "equal": float((d == 0).mean()),
                                      "within_tol": close}
        log(f"  render_point_cloud {w}x{h}, point_size 2: {float((d == 0).mean()):.6f} of "
            f"pixels bit-equal to the CPU run, {close:.6f} within {RENDER_PIXEL_TOL} (need >= "
            f"{RENDER_POINT_SHARE}), coverage {coverage:.4f}; {fmt(nums)}")
        check(img.shape == (h, w, 3) and np.isfinite(img).all() and close >= RENDER_POINT_SHARE,
              f"render_point_cloud {w}x{h} disagrees with the CPU run")
    del host

    mv, mf = uv_sphere(RENDER_SUB)
    mesh = tt.TriangleMesh.from_numpy(mv, mf, device=dev)
    mesh_cpu = tt.TriangleMesh.from_numpy(mv, mf, device=cpu)
    w, h = RENDER_SIZES[0]
    sample = torch.from_numpy(np.random.default_rng(54).choice(w * h, RENDER_SAMPLE,
                                                               replace=False))
    cam, view, intr = tr._mesh_camera(mesh_cpu, None, w, h)
    ld = np.float32([0.4, 0.3, 0.85])
    ld = torch.from_numpy(ld / np.linalg.norm(ld))
    vcol = torch.tensor((0.7, 0.72, 0.78)).expand(mesh_cpu.vertices.shape)
    flat_ref = tr.rasterize_flat(mesh_cpu.vertices, mesh_cpu.faces, mesh_cpu.face_mask, vcol,
                                 view, intr, ld, w, h, pixels=sample).numpy()
    cam, view, intr, m, vcol, mat_vec, light_vec = tr._pbr_inputs(mesh_cpu, None, w, h, None,
                                                                  None)
    pbr_ref = tr.rasterize_pbr(m.vertices, m.faces, m.face_mask, vcol, m.normals, view, intr,
                               torch.as_tensor(np.asarray(cam.eye(), np.float32)), mat_vec,
                               light_vec, w, h, pixels=sample).numpy()
    for name, fn, ref, alias in (
            ("render_mesh", lambda: tr.render_mesh(mesh, width=w, height=h), flat_ref,
             lambda: tr.render_to_texture(mesh, width=w, height=h, shading_mode="flat")),
            ("render_mesh_pbr", lambda: tr.render_mesh_pbr(mesh, width=w, height=h), pbr_ref,
             lambda: tr.render_to_texture(mesh, width=w, height=h, shading_mode="pbr"))):
        img, _ = counted(fn, {})
        got = img.reshape(-1, 3)[sample.numpy()]
        d = np.abs(got - ref).max(-1)
        close = float((d <= RENDER_MESH_TOL).mean())
        # the PBR call computes vertex normals with index_add_, whose atomics
        # add in another order on each call: a second call is held as the CPU
        tex = np.abs(counted(alias, {})[0] - img).max(-1)
        tex_close = float((tex <= RENDER_MESH_TOL).mean())
        nums = once(fn)
        tex_equal = float((tex == 0).mean())
        renders[f"{name} {w}x{h}"] = {**nums, "equal": float((d == 0).mean()),
                                      "within_tol": close, "texture_equal": tex_equal}
        log(f"  {name} {len(mf):,} faces at {w}x{h}: on {RENDER_SAMPLE} sampled pixels "
            f"{float((d == 0).mean()):.4f} bit-equal to the CPU raster, {close:.4f} within "
            f"{RENDER_MESH_TOL} (need >= {RENDER_MESH_SHARE}); render_to_texture's mode "
            f"bit-equal on {tex_equal:.4f} of pixels, within {RENDER_MESH_TOL} "
            f"on {tex_close:.4f}; {fmt(nums)}")
        check(np.isfinite(img).all() and close >= RENDER_MESH_SHARE
              and tex_close >= RENDER_MESH_SHARE, f"{name} disagrees with the CPU raster")
    del mesh, mesh_cpu, flat_ref, pbr_ref

    viewer = InteractiveViewer(*VIEWER_SIZE)
    viewer.set_point_cloud(cloud)
    for key in "adw+hk":
        check(viewer.handle_key(key), f"viewer key {key!r} ended the session")
    frame, _ = counted(viewer.render, {})
    ansi, _ = counted(lambda: viewer.frame_ansi(100, 36), {})
    plane, _ = counted(viewer.run_plane_segmentation, {})
    target = tt.PointCloud.from_numpy(p + SHIFT, device=dev)
    icp_res, counts = run_counted(kernels, total, lambda: viewer.run_icp(target))
    t_v = icp_res.transformation.cpu().numpy()
    nz = abs(float(plane.model.normal[2]))
    log(f"  InteractiveViewer{VIEWER_SIZE}: frame {frame.shape}, ANSI frame of "
        f"{ansi.count(chr(10)) + 1} lines; plane segmentation {int(plane.inlier_count):,} "
        f"inliers, |n_z| {nz:.5f}; run_icp {icp_res.iterations} iterations, launches "
        f"{ {k: n for k, n in counts.items() if n} }, shift within "
        f"{float(np.abs(t_v[:3, 3] - SHIFT).max()):.2e} m")
    check(frame.shape == (VIEWER_SIZE[1], VIEWER_SIZE[0], 3) and ansi.count("▀") == 3600
          and nz > 0.99 and only(counts, {"icp_match": icp_res.iterations})
          and np.abs(t_v[:3, 3] - SHIFT).max() <= 1e-3, "InteractiveViewer failed")
    renders["viewer render"] = once(viewer.render)
    renders["viewer run_icp"] = once(lambda: viewer.run_icp(target))
    for name in ("viewer render", "viewer run_icp"):
        log(f"  {name}: {fmt(renders[name])}")
    report["phase54"] = renders
    log(f"  ({report['card']}, SM clock {sm_clock()})")
    log(f"  phase {phase_seconds()}")
    return total, report


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; nothing to run",
              file=sys.stderr)
        return 1
    from threecrate_tpu_torch import kernels
    from threecrate_tpu_torch.kernels import _build
    from threecrate_tpu_torch.kernels.icp import icp_match_plain, icp_match_tiles
    from threecrate_tpu_torch.kernels.knn import (window_normals_plain,
                                                  window_normals_tiles,
                                                  window_union_a_plain,
                                                  window_union_a_tiles,
                                                  window_union_b_plain,
                                                  window_union_b_tiles)
    from threecrate_tpu_torch.kernels import fpfh
    from threecrate_tpu_torch.kernels.knn_window import knn_window_plain, knn_window_tiles
    from threecrate_tpu_torch.models import PerceptionStep
    from threecrate_tpu_torch.utils.profiling import median_time

    dev = torch.device("cuda:0")
    torch.backends.cuda.matmul.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    card = card_line()
    log(f"phase 1: device {name} | nvidia-smi: {card} | torch {torch.__version__} "
        f"cuda {torch.version.cuda}")

    t0 = time.perf_counter()
    _build.lib()
    log(f"phase 2: kernels built in {time.perf_counter() - t0:.1f} s "
        f"(nvcc {_build.build_seconds} s) -> {_build.library_path().name}")

    log("phase 3: kernel vs plain at full size")
    k, tile, band = 10, 256, 16
    pa, va, row_a, perm_a = sorted_scan(dev)
    pts_a = pa.T.contiguous()
    valid_a = va[None].contiguous()
    out_a = window_union_a_tiles(pts_a, valid_a, k, tile, band)
    ref_a = window_union_a_plain(pts_a, valid_a, k, tile, band)
    torch.cuda.synchronize()
    ea = union_error(out_a, ref_a, va > 0.5)
    log(f"  union_window_a: N={pts_a.shape[1]} cnt+radius bit-equal {ea[0]:.6f} "
        f"(need 1), sums max rel err {ea[1]:.3e} (tol {SUM_REL_TOL}), "
        f"max abs err {ea[2]:.3e}")
    check(ea[0] == 1.0 and ea[1] <= SUM_REL_TOL, "union_window_a disagrees")

    pts_b = pa[row_a].T.contiguous()
    valid_b = va[row_a][None].contiguous()
    pos_b = row_a.to(torch.int32)[None].contiguous()
    hia_b = out_a[10][row_a][None].contiguous()
    args_b = (pts_b, valid_b, pos_b, hia_b, k, tile, band)
    out_b = window_union_b_tiles(*args_b)
    ref_b = window_union_b_plain(*args_b)
    torch.cuda.synchronize()
    vb = valid_b[0] > 0.5
    eb = union_error(out_b, ref_b, vb)
    use_b_share = out_b[10][vb].mean().item()
    log(f"  union_window_b: cnt+use_b bit-equal {eb[0]:.6f} (need 1), sums max rel "
        f"err {eb[1]:.3e} (tol {SUM_REL_TOL}), max abs err {eb[2]:.3e}, "
        f"use_b share {use_b_share:.4f}")
    check(eb[0] == 1.0 and eb[1] <= SUM_REL_TOL, "union_window_b disagrees")
    k_calls, k_err, k_pairs = {}, {}, {}
    for kk in (GICP_K, ANALYSIS_K):
        calls_k, err_k, k_pairs[kk] = union_k_checks(pts_a, valid_a, row_a, tile, band, kk)
        k_calls.update(calls_k)
        k_err.update(err_k)
    normals_err, normals_pairs = normals_kernel_checks(pts_a, valid_a, k, tile)

    ids_a = perm_a.to(torch.int32)[None].contiguous()
    knn_err, knn_open = {}, {}
    for cname, (kk, coords, excl) in KNN_SHAPES.items():
        got = knn_window_tiles(pts_a, valid_a, ids_a, kk, KNN_TILE, with_coords=coords,
                               exclude_self=excl)
        ref = knn_window_plain(pts_a, valid_a, ids_a, kk, KNN_TILE, with_coords=coords,
                               exclude_self=excl)
        torch.cuda.synchronize()
        equal = all(torch.equal(g, r) for g, r in zip(got, ref))
        fin = torch.isfinite(ref[0])
        err = (got[0][fin] - ref[0][fin]).abs().max().item()
        knn_err[knn_name(cname)] = err
        knn_open[knn_name(cname)] = knn_open_columns(pts_a, valid_a, ref[0], KNN_TILE)
        log(f"  knn_window {cname}: N={pts_a.shape[1]} outputs bit-equal {equal} (need "
            f"True), finite slots {fin.float().mean().item():.5f}, max abs err of -d2 "
            f"{err:.3e}, unculled columns a query "
            f"{knn_open[knn_name(cname)][0] / pts_a.shape[1]:.2f} of {3 * KNN_TILE}")
        check(equal, f"knn_window {cname} disagrees")
    del got, ref, fin

    icp_err = 0.0
    icp_args, icp_open = {}, None
    for n_extra in ICP_EXTRAS:
        args = icp_inputs(dev, n_extra)
        got = icp_match_tiles(*args, tile=128, w_tiles=3)
        ref = icp_match_plain(*args, tile=128, w_tiles=3)
        nearest, ties = icp_nearest(*args, 128, 3)
        torch.cuda.synchronize()
        err = (got - ref).abs().max().item()
        match_equal = torch.equal(got[3], ref[3])
        single = ties == 1
        exact = share((got == ref).all(0)[single])
        match_share = got[3].mean().item()
        if n_extra == 0:
            icp_open = icp_open_columns(*args, 128, 3, nearest)
        log(f"  icp_match E={n_extra}: Ns=Nt={args[0].shape[1]} max abs err {err:.3e} "
            f"(tol {ICP_ABS_TOL}), match row bit-equal {match_equal} (need True), all rows "
            f"bit-equal on {exact:.6f} of the points without a tie (need 1; ties "
            f"{(~single).sum().item()}), matched share {match_share:.4f}, unculled columns a "
            f"point {icp_open[0] / args[0].shape[1]:.2f} of {3 * 128}")
        check(err <= ICP_ABS_TOL and match_equal and exact == 1.0 and match_share > 0.99,
              f"icp_match E={n_extra} disagrees")
        icp_err = max(icp_err, err)
        if n_extra == 0:
            icp_args[n_extra] = args
        del args, got, ref, nearest, ties

    pa, pb, pos_b, perm_a = fpfh_inputs(dev)
    v_a, v_b = pa[3] > 0.5, pb[3] > 0.5
    fpfh_err = {}
    # selected (in-radius) pairs of each kernel, from its count row
    pairs = {"union_window_a": ref_a[0].sum().item(), "union_window_b": ref_b[0].sum().item(),
             **normals_pairs}
    stage1 = {}
    fpfh_args = {"spfh_a": (pa,), "spfh_b": (pb, pos_b)}
    run_r2, windows = {}, {}
    for kname, radius in SPFH_RUNS.items():
        base = kname.split()[0]
        kern, plain = getattr(fpfh, base + "_tiles"), getattr(fpfh, base + "_plain")
        v = v_a if base == "spfh_a" else v_b
        run_r2[kname] = radius * radius
        windows[kname] = open_columns(fpfh_args[base][0], FPFH_TILE, run_r2[kname],
                                      "kSpfhChunk")
        got = kern(*fpfh_args[base], run_r2[kname], FPFH_TILE)
        ref = plain(*fpfh_args[base], run_r2[kname], FPFH_TILE)
        torch.cuda.synchronize()
        exact = share((got == ref).all(0)[v])
        fpfh_err[kname] = (got - ref).abs().max().item()
        pairs[kname] = ref[33].sum().item()
        log(f"  {kname}: N={pa.shape[1]} r={radius} vote+count rows bit-equal {exact:.6f} "
            f"(need 1), max abs err {fpfh_err[kname]:.3e}, mean count "
            f"{ref[33][v].mean().item():.2f}, unculled columns a query "
            f"{windows[kname][0] / v.sum().item():.2f} of {3 * FPFH_TILE}")
        check(exact == 1.0, f"{kname} disagrees")
        if kname == base:
            stage1[kname] = got
    # stage 2 on the kernels' SPFH, as _fpfh_fused builds it, at r = 0.5 and
    # at the default FPFH's stage-2 radius
    p2a, p2b = stage2_inputs(pa, pb, pos_b, stage1["spfh_a"], stage1["spfh_b"])
    fpfh_args.update({"fpfh_weight_a": (p2a,), "fpfh_weight_b": (p2b, pos_b)})
    for kname, radius in WEIGHT_RUNS.items():
        base = kname.split()[0]
        kern, plain = getattr(fpfh, base + "_tiles"), getattr(fpfh, base + "_plain")
        v = v_a if base == "fpfh_weight_a" else v_b
        run_r2[kname] = radius * radius
        windows[kname] = open_columns(fpfh_args[base][0], FPFH_TILE, run_r2[kname],
                                      "kWeightChunk")
        got = kern(*fpfh_args[base], run_r2[kname], FPFH_TILE)
        ref = plain(*fpfh_args[base], run_r2[kname], FPFH_TILE)
        torch.cuda.synchronize()
        cnt_exact = share((got[33] == ref[33])[v])
        rel = ((got[:33] - ref[:33]).abs().amax(0)
               / ref[:33].abs().sum(0).clamp_min(1e-30))[v].max().item()
        fpfh_err[kname] = (got - ref).abs().max().item()
        pairs[kname] = ref[33].sum().item()
        log(f"  {kname}: r={radius} count bit-equal {cnt_exact:.6f} (need 1), sums max rel "
            f"err {rel:.3e} (tol {FPFH_REL_TOL}), max abs err {fpfh_err[kname]:.3e}, mean "
            f"count {ref[33][v].mean().item():.2f}, unculled columns a query "
            f"{windows[kname][0] / v.sum().item():.2f} of {3 * FPFH_TILE}")
        check(cnt_exact == 1.0 and rel <= FPFH_REL_TOL, f"{kname} disagrees")
    del stage1

    rb2 = BAND_RADIUS * BAND_RADIUS
    band_args = {"spfh_band_a": (pa,),
                 "spfh_band_b": (torch.cat([pb, pos_b.to(torch.float32)]).contiguous(),)}
    for kname in BAND_KERNELS:
        kern, plain = getattr(fpfh, kname + "_tiles"), getattr(fpfh, kname + "_plain")
        got = kern(*band_args[kname], rb2, BAND, FPFH_TILE)
        ref = plain(*band_args[kname], rb2, BAND, FPFH_TILE)
        torch.cuda.synchronize()
        exact = share((got == ref).all(0))
        fpfh_err[kname] = (got - ref).abs().max().item()
        pairs[kname] = ref[33].sum().item()
        per_query, rounds, offsets = band_warp_work(band_args[kname][0], BAND, rb2,
                                                    7 if kname == "spfh_band_b" else None)
        log(f"  {kname}: N={pa.shape[1]} r={BAND_RADIUS} band={BAND} all 34 rows bit-equal "
            f"{exact:.6f} (need 1), max abs err {fpfh_err[kname]:.3e}, mean count "
            f"{ref[33][v_a if kname == 'spfh_band_a' else v_b].mean().item():.2f}; selected "
            f"pairs a query {per_query:.2f}, drain rounds a warp {rounds:.2f}, offsets a warp "
            f"with a selecting lane {offsets:.2f} of {2 * BAND + 1}")
        check(exact == 1.0, f"{kname} disagrees")
    shot_calls, shot_err, shot_pairs = shot_kernel_checks(pa, pb, pos_b, perm_a)
    pairs.update(shot_pairs)

    log("phase 4: kernel and plain times (CUDA-event medians)")
    times = {
        "union_window_a": (lambda: window_union_a_tiles(pts_a, valid_a, k, tile, band),
                           lambda: window_union_a_plain(pts_a, valid_a, k, tile, band)),
        "union_window_b": (lambda: window_union_b_tiles(*args_b),
                           lambda: window_union_b_plain(*args_b)),
        "icp_match": (lambda: icp_match_tiles(*icp_args[0], tile=128, w_tiles=3),
                      lambda: icp_match_plain(*icp_args[0], tile=128, w_tiles=3)),
    }
    for kname in (*SPFH_RUNS, *WEIGHT_RUNS):
        base = kname.split()[0]
        kern, plain = getattr(fpfh, base + "_tiles"), getattr(fpfh, base + "_plain")
        args, kr2 = fpfh_args[base], run_r2[kname]
        times[kname] = (lambda kern=kern, args=args, kr2=kr2: kern(*args, kr2, FPFH_TILE),
                        lambda plain=plain, args=args, kr2=kr2: plain(*args, kr2, FPFH_TILE))
    for kname in BAND_KERNELS:
        kern, plain = getattr(fpfh, kname + "_tiles"), getattr(fpfh, kname + "_plain")
        args = band_args[kname]
        times[kname] = (lambda kern=kern, args=args: kern(*args, rb2, BAND, FPFH_TILE),
                        lambda plain=plain, args=args: plain(*args, rb2, BAND, FPFH_TILE))
    for cname, (kk, coords, excl) in KNN_SHAPES.items():
        knn_args = (pts_a, valid_a, ids_a, kk, KNN_TILE, coords, excl)
        times[knn_name(cname)] = (lambda a=knn_args: knn_window_tiles(*a),
                                  lambda a=knn_args: knn_window_plain(*a))
    times.update(shot_calls)
    for tname, nband in NORMALS_BANDS.items():
        times[tname] = (lambda b=nband: window_normals_tiles(pts_a, valid_a, k, tile, b),
                        lambda b=nband: window_normals_plain(pts_a, valid_a, k, tile, b))
    ms = {}
    for kname, (kern, plain) in times.items():
        # plain, kernel, kernel, plain: compare within one call, in turns
        spare = kname in SPARE_PLAIN
        p1 = median_time(plain, warmup=0 if spare else 1, iters=1 if spare else 5)
        k1 = median_time(kern, warmup=1, iters=10)
        k2 = median_time(kern, warmup=0, iters=10)
        p2 = median_time(plain, warmup=0, iters=1 if spare else 5)
        ms[kname] = (1e3 * (k1 + k2) / 2, 1e3 * (p1 + p2) / 2)
        log(f"  {kname}: kernel {1e3 * k1:.4f} / {1e3 * k2:.4f} ms, plain "
            f"{1e3 * p1:.4f} / {1e3 * p2:.4f} ms; SM clock {sm_clock()}")
    for kname, (kern, plain_ms) in k_calls.items():
        k1 = median_time(kern, warmup=1, iters=10)
        k2 = median_time(kern, warmup=0, iters=10)
        ms[kname] = (1e3 * (k1 + k2) / 2, plain_ms)
        log(f"  {kname}: kernel {1e3 * k1:.4f} / {1e3 * k2:.4f} ms, plain {plain_ms:.4f} ms "
            f"(phase 3's one call); SM clock {sm_clock()}")
    work = kernel_work(pts_a.shape[1], tile, band, icp_args[0], pa.shape[1], pairs,
                       {**windows, **knn_open, "icp_match": icp_open})
    for kk, pairs_k in k_pairs.items():
        work[f"union_window_a k={kk}"], work[f"union_window_b k={kk}"] = union_work(
            pts_a.shape[1], tile, max(band, kk), *pairs_k)
    del out_a, ref_a, out_b, ref_b, icp_args, times, ids_a, knn_args, shot_calls, k_calls
    del fpfh_args, band_args, pa, pb, p2a, p2b, pos_b, perm_a, v_a, v_b, got, ref, args
    torch.cuda.empty_cache()
    match_rows = match_kernel_row(dev)
    torch.cuda.empty_cache()

    log("phase 5: PerceptionStep() on the 1M scan pair")
    src = scan(N_SCAN, 0)
    tgt = src + SHIFT
    mask = np.ones(N_SCAN, bool)
    step = PerceptionStep()
    kernels.reset_launch_counts()
    res = step(src, mask, tgt, mask)
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    t = res.transform.cpu().numpy()
    nrm = res.normals
    norms = torch.linalg.vector_norm(nrm, dim=1)
    valid_n = norms > 0
    log(f"  launches {launches}; translation {t[:3, 3].tolist()}; mse "
        f"{res.mse.item():.3e}; valid normals {valid_n.float().mean().item():.5f}")
    check(t.shape == (4, 4) and np.isfinite(t).all(), "transform not finite")
    check(np.abs(t[:3, 3] - SHIFT).max() <= 1e-3, "shift not recovered within 1e-3")
    check(np.abs(t[:3, :3] - np.eye(3)).max() <= 1e-3, "rotation not identity")
    check(tuple(nrm.shape) == (N_SCAN, 3) and bool(torch.isfinite(nrm).all()),
          "normals not finite")
    check(valid_n.float().mean().item() > 0.99, "fewer than 99% valid normals")
    check(bool(((norms[valid_n] - 1).abs() < 1e-3).all()), "normals not unit length")
    check(launches["union_window_a"] == 1 and launches["union_window_b"] == 1,
          "union kernels not launched once each")
    check(not any(launches[k] for k in FPFH_KERNELS + BAND_KERNELS + ("knn_window",)),
          "FPFH, banded SPFH or window kNN kernels launched")
    check(1 <= launches["icp_match"] <= step.max_iterations,
          "icp_match not launched once per iteration")
    phase5 = (t.copy(), dict(launches))

    log("phase 6: PerceptionStep() step time on the 1M scan pair")
    torch.cuda.reset_peak_memory_stats()
    step_s = median_time(lambda: step(src, mask, tgt, mask), warmup=1, iters=3)
    peak = torch.cuda.max_memory_allocated()
    log(f"  step {1e3 * step_s:.2f} ms median of 3, {1.0 / step_s:.3f} pairs/s, "
        f"peak allocated {peak / 2**30:.3f} GiB")

    log("phase 7: PerceptionStep() on 2,048 points (exact kNN path)")
    rng = np.random.default_rng(0)
    xy = rng.uniform(-2, 2, (2048, 2)).astype(np.float32)
    z = 0.4 * np.sin(xy[:, 0] * 2.0) + 0.3 * np.cos(xy[:, 1] * 1.7)
    small = np.stack([xy[:, 0], xy[:, 1], z], -1).astype(np.float32)
    shift = np.array([0.03, -0.01, 0.02], np.float32)
    m = np.ones(2048, bool)
    kernels.reset_launch_counts()
    r2 = PerceptionStep()(small, m, small + shift, m)
    t2 = r2.transform.cpu().numpy()
    n2 = torch.linalg.vector_norm(r2.normals, dim=1).cpu().numpy()
    log(f"  translation {t2[:3, 3].tolist()}, mse {r2.mse.item():.3e}, "
        f"launches {kernels.launch_counts()}")
    check(np.abs(t2[:3, 3] - shift).max() <= 5e-3, "2,048-point shift not recovered")
    check(np.allclose(n2, 1.0, atol=1e-3), "2,048-point normals not unit length")
    check(r2.mse.item() < 1e-4, "2,048-point mse too large")
    check(sum(kernels.launch_counts().values()) == 0, "exact path launched a kernel")

    reg_launches, reg_report = registration_phases(dev, kernels)
    win_launches, win_report = window_phases(dev, kernels)
    shot_launches, shot_report = shot_phases(dev, kernels)
    fast_launches, fast_report = window_fast_phases(dev, kernels)
    fam_launches, fam_report = registration_family_phases(dev, kernels)
    depth_launches, depth_report = depth_camera_phases(dev, kernels)
    surf_launches, surf_report = surface_phases(dev, kernels)
    mesh_launches, mesh_report = mesh_phases(dev, kernels)
    io_launches, io_report = io_phases(dev, kernels, *phase5)
    survey_launches, survey_report = survey_phases(dev, kernels)
    par_launches, par_report = parallel_phases(dev, kernels)
    root_launches, root_report = root_surface_phases(dev, kernels)
    slab_launches, slab_report = slab_phases(dev, kernels)
    for part in (reg_launches, win_launches, shot_launches, fast_launches, fam_launches,
                 depth_launches, surf_launches, mesh_launches, io_launches, survey_launches,
                 par_launches, root_launches, slab_launches):
        for kname, n in part.items():
            launches[kname] = launches.get(kname, 0) + n

    src_of = {"union_window_a": ("threecrate_tpu_torch/csrc/union_window.cu",
                                 "threecrate_tpu/kernels/knn_pallas.py:564"),
              "union_window_b": ("threecrate_tpu_torch/csrc/union_window.cu",
                                 "threecrate_tpu/kernels/knn_pallas.py:600"),
              "union_window_a k=20": ("threecrate_tpu_torch/csrc/union_window.cu",
                                      "threecrate_tpu/kernels/knn_pallas.py:564"),
              "union_window_b k=20": ("threecrate_tpu_torch/csrc/union_window.cu",
                                      "threecrate_tpu/kernels/knn_pallas.py:600"),
              "union_window_a k=8": ("threecrate_tpu_torch/csrc/union_window.cu",
                                     "threecrate_tpu/kernels/knn_pallas.py:564"),
              "union_window_b k=8": ("threecrate_tpu_torch/csrc/union_window.cu",
                                     "threecrate_tpu/kernels/knn_pallas.py:600"),
              "icp_match": ("threecrate_tpu_torch/csrc/icp_match.cu",
                            "threecrate_tpu/kernels/icp_pallas.py:113"),
              "spfh_a": ("threecrate_tpu_torch/csrc/fpfh.cu",
                         "threecrate_tpu/kernels/fpfh_pallas.py:189"),
              "spfh_b": ("threecrate_tpu_torch/csrc/fpfh.cu",
                         "threecrate_tpu/kernels/fpfh_pallas.py:211"),
              "spfh_a r=0.25": ("threecrate_tpu_torch/csrc/fpfh.cu",
                                "threecrate_tpu/kernels/fpfh_pallas.py:189"),
              "spfh_b r=0.25": ("threecrate_tpu_torch/csrc/fpfh.cu",
                                "threecrate_tpu/kernels/fpfh_pallas.py:211"),
              "fpfh_weight_a": ("threecrate_tpu_torch/csrc/fpfh.cu",
                                "threecrate_tpu/kernels/fpfh_pallas.py:292"),
              "fpfh_weight_b": ("threecrate_tpu_torch/csrc/fpfh.cu",
                                "threecrate_tpu/kernels/fpfh_pallas.py:314"),
              "fpfh_weight_a r=0.25": ("threecrate_tpu_torch/csrc/fpfh.cu",
                                       "threecrate_tpu/kernels/fpfh_pallas.py:292"),
              "fpfh_weight_b r=0.25": ("threecrate_tpu_torch/csrc/fpfh.cu",
                                       "threecrate_tpu/kernels/fpfh_pallas.py:314"),
              "spfh_band_a": ("threecrate_tpu_torch/csrc/fpfh.cu",
                              "threecrate_tpu/kernels/fpfh_pallas.py:444"),
              "spfh_band_b": ("threecrate_tpu_torch/csrc/fpfh.cu",
                              "threecrate_tpu/kernels/fpfh_pallas.py:468"),
              **{knn_name(cname): ("threecrate_tpu_torch/csrc/knn_window.cu",
                                   "threecrate_tpu/kernels/knn_pallas.py:645")
                 for cname in KNN_CONFIGS},
              "shot_moments_a": ("threecrate_tpu_torch/csrc/shot.cu",
                                 "threecrate_tpu/kernels/shot_pallas.py:262"),
              "shot_moments_b": ("threecrate_tpu_torch/csrc/shot.cu",
                                 "threecrate_tpu/kernels/shot_pallas.py:285"),
              "shot_moments_b placed": ("threecrate_tpu_torch/csrc/shot.cu",
                                        "threecrate_tpu/kernels/shot_pallas.py:285"),
              "shot_moments_a plus": ("threecrate_tpu_torch/csrc/shot.cu",
                                      "threecrate_tpu/kernels/shot_pallas.py:262"),
              "shot_hist_a": ("threecrate_tpu_torch/csrc/shot.cu",
                              "threecrate_tpu/kernels/shot_pallas.py:308"),
              "shot_hist_b": ("threecrate_tpu_torch/csrc/shot.cu",
                              "threecrate_tpu/kernels/shot_pallas.py:335"),
              "shot_hist_b placed": ("threecrate_tpu_torch/csrc/shot.cu",
                                     "threecrate_tpu/kernels/shot_pallas.py:335"),
              "shot_hist_a add": ("threecrate_tpu_torch/csrc/shot.cu",
                                  "threecrate_tpu/kernels/shot_pallas.py:308"),
              "window_normals": ("threecrate_tpu_torch/csrc/union_window.cu",
                                 "threecrate_tpu/kernels/knn_pallas.py:505")}
    errs = {"union_window_a": ea[2], "union_window_b": eb[2], "icp_match": icp_err,
            **knn_err, "window_normals": normals_err, **fpfh_err, **shot_err, **k_err}
    for kname in ("shot_hist_a", "shot_hist_b", "shot_hist_b placed", "shot_hist_a add"):
        errs[kname] = max(errs[kname], errs.pop(f"{kname} usc"))   # both variants
    # each knn_window entry counts its own shape's launches
    launch_key = {knn_name(cname): f"knn_window {cname}" for cname in KNN_CONFIGS}
    report = {"kernels": []}
    for kname in src_of:
        bound_ms, bound_by = bound(*work[kname])
        report["kernels"].append(
            {"name": kname, "route": "cuda", "source": src_of[kname][0],
             "replaces": src_of[kname][1],
             "launches": launches.get(launch_key.get(kname, kname.split()[0]), 0),
             "max_abs_err": errs[kname], "ms": ms[kname][0], "plain_ms": ms[kname][1],
             "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None})
    for row in match_rows:
        row["launches"] = reg_launches["match_nearest"]
        report["kernels"].append(row)
    usc_ms = {k: ms[f"{k} usc"] for k in ("shot_hist_a", "shot_hist_b", "shot_hist_b placed",
                                          "shot_hist_a add")}
    usc_bound = {k: bound(*work[f"{k} usc"]) for k in usc_ms}
    log(f"USC histograms (kernel ms, plain ms; bound ms, by): {json.dumps(usc_ms)} "
        f"{json.dumps(usc_bound)}")
    log("SHOT histogram bounds (ms, by), write and add modes: " + json.dumps(
        {k: bound(*work[k]) for k in ("shot_hist_a", "shot_hist_b", "shot_hist_b placed",
                                      "shot_hist_a add")}))
    log(f"registration: {json.dumps(reg_report)}")
    log(f"window paths: {json.dumps(win_report)}")
    log(f"shot paths: {json.dumps(shot_report)}")
    exact_ms = ms["window_normals band=0"]
    log(f"window_normals band=0 (kernel ms, plain ms; bound ms, by): {json.dumps(exact_ms)} "
        f"{json.dumps(bound(*work['window_normals band=0']))}")
    k128 = knn_name(KNN_K128)
    log(f"{k128} (kernel ms, plain ms; bound ms, by; max abs err): {json.dumps(ms[k128])} "
        f"{json.dumps(bound(*work[k128]))} {errs[k128]}")
    log(f"window_fast, voxel grid and ICP variants: {json.dumps(fast_report)}")
    log(f"GICP, Patchwork++, NDT and odometry: {json.dumps(fam_report)}")
    log(f"depth-camera slice: {json.dumps(depth_report)}")
    log(f"surface slice: {json.dumps(surf_report)}")
    log(f"mesh-processing slice: {json.dumps(mesh_report)}")
    log(f"file-to-segments slice: {json.dumps(io_report)}")
    log(f"survey-tile slice: {json.dumps(survey_report)}")
    log(f"multi-shard points axis: {json.dumps(par_report)}")
    log(f"user-facing surface: {json.dumps(root_report)}")
    log(f"the last of parallel: {json.dumps(slab_report)}")
    print(card)
    print(json.dumps(report))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


def fpfh_like(n, gen, dev):
    """(n, 33) rows shaped as FPFH histograms: three groups of 11
    non-negative bins, each summing to 100."""
    h = torch.rand((n, 3, 11), generator=gen, device=dev) ** 3
    return (100.0 * h / h.sum(2, keepdim=True)).reshape(n, 33)


def match_kernel_row(dev):
    """Descriptor matching's kernel at ``MATCH_SHAPE``, each direction:
    checked against the plain version (``neighbors.knn``, the tiled path)
    and timed beside it, beside its bound (2·Q·N·D operations) and beside
    a chunked library yardstick (cuBLAS fp32 product, norms, argmin) that
    the port never calls. Returns the report's kernel rows."""
    from threecrate_tpu_torch.kernels import match
    from threecrate_tpu_torch.ops import neighbors
    from threecrate_tpu_torch.utils.profiling import median_time

    q, n, d = MATCH_SHAPE
    gen = torch.Generator(device=dev)
    gen.manual_seed(26)
    tgt = fpfh_like(n, gen, dev)
    src = tgt[torch.randperm(n, generator=gen, device=dev)[:q]]
    src = src + torch.rand(src.shape, generator=gen, device=dev)      # near copies
    v_src = torch.rand(q, generator=gen, device=dev) > 0.02
    v_tgt = torch.rand(n, generator=gen, device=dev) > 0.02

    def library(queries, db, db_valid, chunk):
        # the yardstick: (|q|^2 + |p|^2) - 2 q.p by cuBLAS, then argmin
        pn = torch.where(db_valid, (db * db).sum(1), torch.inf)
        for c in range(0, queries.shape[0], chunk):
            qc = queries[c:c + chunk]
            ((qc * qc).sum(1)[:, None] + pn[None]).addmm_(qc, db.T, alpha=-2.0).argmin(1)

    rows = []
    for direction, (qs, db, db_valid, chunk) in {
            "forward": (src, tgt, v_tgt, 1024), "mutual": (tgt, src, v_src, 16_384)}.items():
        d2, j = match.unpack(match._nearest(qs, db, db_valid))
        ref = neighbors.knn(db, db_valid, qs, None, 1)
        torch.cuda.synchronize()
        rj, rd = ref.indices[:, 0], ref.distances[:, 0]
        same = rj == j
        ulp = 2.0 ** -23 * ((qs * qs).sum(1) + (db[j] * db[j]).sum(1))
        d2_ulps = ((d2 - rd * rd).abs() / ulp)[same].max().item()
        ids_eq = same.float().mean().item()
        log(f"  match_nearest {direction}: {qs.shape[0]:,} x {db.shape[0]:,} x {d}, rows equal "
            f"to neighbors.knn's on {ids_eq:.7f} (need >= 0.999: near-ties may flip), d2 within "
            f"{d2_ulps:.2f} ulps of |q|^2 + |p|^2 (need <= {D2_ULPS}, with the plain's sqrt "
            f"squared back)")
        check(ids_eq >= 0.999 and d2_ulps <= D2_ULPS, f"match_nearest {direction} disagrees")
        kern = functools.partial(match._nearest, qs, db, db_valid)
        plain = functools.partial(neighbors.knn, db, db_valid, qs, None, 1)
        lib = functools.partial(library, qs, db, db_valid, chunk)
        # plain, kernel, kernel, plain; the library yardstick between
        p1 = median_time(plain, warmup=1, iters=1)
        k1 = median_time(kern, warmup=1, iters=10)
        lib_ms = 1e3 * median_time(lib, warmup=1, iters=3)
        k2 = median_time(kern, warmup=0, iters=10)
        p2 = median_time(plain, warmup=0, iters=1)
        bound_ms, bound_by = bound(4.0 * (qs.shape[0] + db.shape[0]) * (d + 1) + 8 * qs.shape[0],
                                   2.0 * qs.shape[0] * db.shape[0] * d)
        ms = 1e3 * (k1 + k2) / 2
        log(f"  match_nearest {direction}: kernel {1e3 * k1:.3f} / {1e3 * k2:.3f} ms, plain "
            f"{1e3 * p1:.1f} / {1e3 * p2:.1f} ms, library {lib_ms:.2f} ms, bound {bound_ms:.2f} "
            f"ms ({bound_by}; {100 * bound_ms / ms:.1f}% of it); SM clock {sm_clock()}")
        rows.append({"name": f"match_nearest {direction}", "route": "cuda",
                     "source": "threecrate_tpu_torch/csrc/match.cu", "replaces": None,
                     "launches": None, "max_abs_err": (d2 - rd * rd)[same].abs().max().item(),
                     "ms": ms, "plain_ms": 1e3 * (p1 + p2) / 2, "bound_ms": bound_ms,
                     "bound_by": bound_by, "library_ms": lib_ms})
    return rows


def registration_phases(dev, kernels):
    """Phases 8-10: ``RegistrationModel`` on the 1M pair (checked, with
    its launch counts), its times, and a 700-point run on the exact
    path. Returns (launches of phase 8, numbers for the log)."""
    import threecrate_tpu_torch as tt
    from threecrate_tpu_torch.ops import global_registration as greg
    from threecrate_tpu_torch.ops import registration
    from threecrate_tpu_torch.ops.features import (FpfhConfig,
                                                   extract_fpfh_features_with_normals,
                                                   match_descriptors)
    from threecrate_tpu_torch.ops.normals import estimate_normals_detailed
    from threecrate_tpu_torch.utils.profiling import median_time

    log("phase 8: RegistrationModel on the 1M scan pair")
    src_np, tgt_np, rot = registration_pair()
    src = tt.PointCloud.from_numpy(src_np, device=dev)
    tgt = tt.PointCloud.from_numpy(tgt_np, device=dev)
    model = tt.RegistrationModel(max_iterations=30, **REG_CONFIG)
    kernels.reset_launch_counts()
    res = model(src, tgt)
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    t = res.transformation.cpu().numpy()
    r_err, t_err = pose_error(t, rot)
    log(f"  launches {launches}; |R'R - I| {r_err:.3e} (tol 1e-3), |R't + t'| "
        f"{t_err:.3e} m (tol 1e-2), ICP iterations {res.iterations}, mse "
        f"{res.mse.item():.3e}, correspondences {res.correspondences}")
    check(np.isfinite(t).all() and r_err <= 1e-3 and t_err <= 1e-2,
          "RegistrationModel pose not recovered")
    check(all(launches[k] == 2 for k in FPFH_KERNELS),
          "an FPFH kernel not launched once per cloud")
    check(launches["union_window_a"] == 2 and launches["union_window_b"] == 2,
          "union kernels not launched once per cloud")
    check(launches["icp_match"] >= 1, "icp_match not launched")
    check(launches["match_nearest"] == 2, "the matching kernel not launched once a direction")
    check(not any(launches[k] for k in BAND_KERNELS + ("knn_window",)),
          "banded SPFH or window kNN kernels launched (fpfh_band=None)")

    log("phase 9: RegistrationModel time, memory and stages on the 1M pair")
    torch.cuda.reset_peak_memory_stats()
    total = median_time(lambda: model(src, tgt), warmup=1, iters=3)
    peak = torch.cuda.max_memory_allocated()
    cfg = model.config
    ncfg = tt.NormalEstimationConfig(k_neighbors=cfg.k_normals)
    src_n = src.with_normals(estimate_normals_detailed(src, ncfg).normals)
    tgt_n = tgt.with_normals(estimate_normals_detailed(tgt, ncfg).normals)
    fcfg = FpfhConfig(radius=cfg.fpfh_radius, band=cfg.fpfh_band)
    sf = extract_fpfh_features_with_normals(src_n, fcfg)
    tf = extract_fpfh_features_with_normals(tgt_n, fcfg)
    stride = -(-src.capacity // cfg.max_query_descriptors)
    glob = greg.global_registration_with_features(
        src_n, tgt_n, sf.descriptors, sf.valid, tf.descriptors, tf.valid, cfg)
    desc_ok = sf.valid.float().mean().item(), tf.valid.float().mean().item()
    sums = sf.descriptors[sf.valid].reshape(-1, 3, 11).sum(2)
    check(bool(torch.isfinite(sf.descriptors).all())
          and bool(((sums - 100).abs() < 1e-2).all()),
          "FPFH descriptors not normalised")
    stages = {
        "normals x2": lambda: [estimate_normals_detailed(c, ncfg) for c in (src, tgt)],
        "fpfh x2": lambda: [extract_fpfh_features_with_normals(c, fcfg)
                            for c in (src_n, tgt_n)],
        "matching": lambda: match_descriptors(
            sf.descriptors[::stride], sf.valid[::stride], tf.descriptors, tf.valid,
            mutual=cfg.mutual_check),
        "matching + ransac": lambda: greg.global_registration_with_features(
            src_n, tgt_n, sf.descriptors, sf.valid, tf.descriptors, tf.valid, cfg),
        "icp": lambda: registration.icp_point_to_point(
            src, tgt, max_iterations=model.max_iterations, init=glob.as_transform()),
    }
    stage_ms = {k: 1e3 * median_time(fn, warmup=1, iters=3) for k, fn in stages.items()}
    stage_ms["ransac"] = stage_ms["matching + ransac"] - stage_ms["matching"]
    log(f"  RegistrationModel {1e3 * total:.2f} ms median of 3, peak allocated "
        f"{peak / 2**30:.3f} GiB; RANSAC inlier ratio {glob.inlier_ratio.item():.4f}; "
        f"valid FPFH share src {desc_ok[0]:.4f} tgt {desc_ok[1]:.4f}")
    for k, v in stage_ms.items():
        log(f"  stage {k}: {v:.2f} ms")

    log("phase 10: RegistrationModel on 700 points (exact FPFH path)")
    rng = np.random.default_rng(4)
    xy = rng.uniform(-2, 2, (700, 2)).astype(np.float32)
    z = 0.5 * np.sin(xy[:, 0] * 2.5) * np.cos(xy[:, 1] * 1.5)
    small = np.stack([xy[:, 0], xy[:, 1], z], -1).astype(np.float32)
    m = (tt.Transform.from_axis_angle([0, 0, 1.0], 0.6)
         @ tt.Transform.from_translation([1.5, -0.8, 0.4])).matrix.numpy()
    moved = (small @ m[:3, :3].T + m[:3, 3]).astype(np.float32)
    kernels.reset_launch_counts()
    r_small = tt.RegistrationModel(max_iterations=30, ransac_iterations=8192,
                                   fpfh_radius=0.5, distance_threshold=0.05)(
        tt.PointCloud.from_numpy(small, device=dev),
        tt.PointCloud.from_numpy(moved, device=dev))
    err_small = float(np.abs(r_small.transformation.cpu().numpy() - m).max())
    log(f"  pose max abs err {err_small:.3e} (tol 0.05), launches "
        f"{kernels.launch_counts()}")
    check(err_small <= 0.05, "700-point pose not recovered")
    check(only(kernels.launch_counts(), {"match_nearest": 2}),
          "exact path launched another kernel than matching's")
    report = {"model_ms": 1e3 * total, "peak_gib": peak / 2**30,
              "pose_err": [r_err, t_err], "stage_ms": stage_ms}
    return launches, report


def window_phases(dev, kernels):
    """Phases 11-14: the default FPFH (a band rung) on the 1M registration
    target, ``method="window"`` normals and statistical outlier removal on
    the 1M scan, and the staged window FPFH on the target. Returns
    (launches summed over the four checked runs, numbers for the log)."""
    import threecrate_tpu_torch as tt
    from threecrate_tpu_torch.ops import filtering, neighbors
    from threecrate_tpu_torch.ops.features import FpfhConfig, _resolve_fpfh_band
    from threecrate_tpu_torch.utils.profiling import device_profile, median_time

    total = dict.fromkeys(kernels.WRAPPERS, 0)

    def run(fn):
        return run_counted(kernels, total, fn)

    def normalised(res):
        d = res.descriptors[res.valid].reshape(-1, 3, 11)
        return bool(torch.isfinite(res.descriptors).all()) and bool(
            ((d.sum(2) - 100).abs() < 1e-2).all())

    log("phase 11: extract_fpfh_features(target), default settings, on the 1M target")
    _, tgt_np, _ = registration_pair()
    tgt = tt.PointCloud.from_numpy(tgt_np, device=dev)
    band = _resolve_fpfh_band("auto", tgt.points, tgt.mask, FpfhConfig().radius)
    res, counts = run(lambda: tt.extract_fpfh_features(tgt))
    valid_share = res.valid.float().sum().item() / N_SCAN
    log(f"  resolved band {band} (expect {BAND}); launches {counts}")
    check(band == BAND, f"band='auto' resolved to {band}, not {BAND}")
    check(only(counts, {"union_window_a": 1, "union_window_b": 1, "spfh_band_a": 1,
                        "spfh_band_b": 1, "fpfh_weight_a": 1, "fpfh_weight_b": 1}),
          "default FPFH did not launch exactly union, band and weight kernels once each")
    check(normalised(res), "default FPFH descriptors not finite or not normalised")
    tgt_n = tgt.with_normals(tt.estimate_normals_detailed(tgt).normals)
    full = tt.extract_fpfh_features_with_normals(tgt_n, FpfhConfig(band=None))
    # a point is valid with >= 3 in-radius neighbours: at r = 0.25 on this
    # scan about 73% of points have that many at all, so the banded share
    # is held against the full window's
    full_share = full.valid.float().sum().item() / N_SCAN
    log(f"  valid share {valid_share:.4f}, full window (band=None) {full_share:.4f} "
        f"(need >= 0.97 of it)")
    check(valid_share >= 0.97 * full_share, "banding lost valid descriptors")
    both = full.valid & res.valid
    da, db = res.descriptors[both], full.descriptors[both]
    cos = (da * db).sum(1) / (da.norm(dim=1) * db.norm(dim=1)).clamp_min(1e-12)
    med_cos, share99 = cos.median().item(), (cos > 0.99).float().mean().item()
    log(f"  cosine vs band=None on the same cloud and normals: median {med_cos:.6f} "
        f"(need >= 0.99), share above 0.99 {share99:.4f}")
    check(med_cos >= 0.99, "banded FPFH too far from the full window")
    del full, da, db, cos, both
    torch.cuda.reset_peak_memory_stats()
    t_default = median_time(lambda: tt.extract_fpfh_features(tgt), warmup=1, iters=3)
    peak_default = torch.cuda.max_memory_allocated()
    t_band = median_time(lambda: tt.extract_fpfh_features_with_normals(tgt_n, FpfhConfig()),
                         warmup=1, iters=3)
    t_full = median_time(lambda: tt.extract_fpfh_features_with_normals(
        tgt_n, FpfhConfig(band=None)), warmup=1, iters=3)
    log(f"  extract_fpfh_features (normals included) {1e3 * t_default:.2f} ms median of 3, "
        f"peak allocated {peak_default / 2**30:.3f} GiB; FPFH on given normals: band "
        f"{band} {1e3 * t_band:.2f} ms, band=None {1e3 * t_full:.2f} ms")
    fpfh_wall, fpfh_busy, entries = device_profile(lambda: tt.extract_fpfh_features(tgt))
    log(f"  profiled call: wall {fpfh_wall:.2f} ms, device busy {fpfh_busy:.2f} ms, idle "
        f"share {1 - fpfh_busy / fpfh_wall:.3f}; largest device entries:")
    for ename, ems, ecount in entries:
        log(f"    {ems:9.3f} ms x{ecount:<4d} {ename[:100]}")

    log("phase 12: method='window' normals on the 1M scan")
    pc = tt.PointCloud.from_numpy(scan(N_SCAN, 0), device=dev)
    wcfg = tt.NormalEstimationConfig(method="window")
    wres, counts = run(lambda: tt.estimate_normals_detailed(pc, wcfg))
    ures = tt.estimate_normals_detailed(pc)
    w_share = wres.valid.float().sum().item() / N_SCAN
    norms = wres.normals[wres.valid].norm(dim=1)
    both = wres.valid & ures.valid
    cos_n = (wres.normals[both] * ures.normals[both]).sum(1).abs()
    med_n = cos_n.median().item()
    log(f"  launches {counts}; valid share {w_share:.5f}; median |cos| vs the default "
        f"union normals {med_n:.6f} (need >= 0.999), share above 0.99 "
        f"{(cos_n > 0.99).float().mean().item():.4f}")
    check(only(counts, {"knn_window": 2}), "window normals did not launch knn_window twice")
    check(w_share > 0.99 and bool(((norms - 1).abs() < 1e-3).all()),
          "window normals: fewer than 99% valid or not unit length")
    check(med_n >= 0.999, "window normals too far from the union normals")
    t_wn = median_time(lambda: tt.estimate_normals_detailed(pc, wcfg), warmup=1, iters=3)
    wn_busy = busy_time(lambda: tt.estimate_normals_detailed(pc, wcfg))
    log(f"  window normals {1e3 * t_wn:.2f} ms median of 3, device busy {wn_busy:.2f} ms")
    del wres, ures, norms, cos_n, both

    log("phase 13: statistical_outlier_removal(cloud), defaults, on the 1M scan")
    sor, counts = run(lambda: tt.statistical_outlier_removal(pc))
    kept = sor.inlier_mask.float().sum().item() / N_SCAN
    _, mean_w, thresh = filtering._statistical_mask(pc.points, pc.mask, 8, 1.0, window=True)
    sub = torch.arange(0, N_SCAN, N_SCAN // 16384, device=dev)[:16384]
    q = pc.points[sub]
    # exact reference: neighbors.knn's candidates (its d^2 expands
    # |q|^2 + |p|^2 - 2q.p, ~1e-3 m^2 off at 100 m), distances recomputed
    # as direct differences, the 9 smallest, the mean formula of the filter
    cand = neighbors.knn(pc.points, pc.mask, q, None, 16)
    d = torch.where(cand.mask, (pc.points[cand.indices] - q[:, None]).norm(dim=-1), torch.inf)
    d9 = torch.sort(d, dim=1).values[:, :9]
    ok = torch.isfinite(d9)
    mean_x = torch.where(ok, d9, 0.0).sum(1) / (ok.sum(1) - 1).clamp_min(1)
    rel = (mean_w[sub] - mean_x).abs() / mean_x.clamp_min(1e-30)
    agree = (rel <= 1e-4).float().mean().item()
    # a window search can only miss neighbours: its mean is never below
    # the exact one (the exact side's candidates come from the expanded d^2)
    not_below = (mean_w[sub] >= mean_x * (1 - 1e-4)).float().mean().item()
    log(f"  launches {counts}; kept share {kept:.5f}, threshold {thresh.item():.6f} m; "
        f"window vs exact mean distance within 1e-4 on {agree:.4f} of 16,384 (need >= "
        f"0.8), not below it on {not_below:.5f} (need >= 0.999), median rel err "
        f"{rel.median().item():.3e}")
    check(only(counts, {"knn_window": 2}), "outlier removal did not launch knn_window twice")
    check(agree >= 0.8 and not_below >= 0.999,
          "window mean distances disagree with the exact ones")
    t_sor = median_time(lambda: tt.statistical_outlier_removal(pc), warmup=1, iters=3)
    sor_busy = busy_time(lambda: tt.statistical_outlier_removal(pc))
    log(f"  statistical_outlier_removal {1e3 * t_sor:.2f} ms median of 3, device busy "
        f"{sor_busy:.2f} ms")
    del sor, mean_w, cand, d, d9, pc

    log("phase 14: extract_fpfh_features_with_normals(target, FpfhConfig(soft_binning=True))")
    scfg = FpfhConfig(soft_binning=True)
    sres, counts = run(lambda: tt.extract_fpfh_features_with_normals(tgt_n, scfg))
    shapes = dict(kernels.knn_window_tiles.shape_launches)
    s_share = sres.valid.float().sum().item() / N_SCAN
    log(f"  launches {counts} by (k, with_coords, exclude_self) {shapes}; valid share "
        f"{s_share:.4f}")
    check(only(counts, {"knn_window": 2}) and shapes == {(64, False, True): 2},
          "staged FPFH did not search k=64 with self excluded in two kernel launches")
    check(normalised(sres), "staged FPFH descriptors not finite or not normalised")
    torch.cuda.reset_peak_memory_stats()
    t_soft = median_time(lambda: tt.extract_fpfh_features_with_normals(tgt_n, scfg),
                         warmup=1, iters=3)
    peak_soft = torch.cuda.max_memory_allocated()
    soft_busy = busy_time(lambda: tt.extract_fpfh_features_with_normals(tgt_n, scfg))
    log(f"  staged window FPFH {1e3 * t_soft:.2f} ms median of 3, peak allocated "
        f"{peak_soft / 2**30:.3f} GiB, device busy {soft_busy:.2f} ms")
    report = {"band": band, "fpfh_valid_share": [valid_share, full_share],
              "fpfh_default_ms": 1e3 * t_default,
              "fpfh_band_ms": 1e3 * t_band, "fpfh_full_ms": 1e3 * t_full,
              "fpfh_default_peak_gib": peak_default / 2**30, "band_median_cos": med_cos,
              "fpfh_profiled_wall_ms": fpfh_wall, "fpfh_busy_ms": fpfh_busy,
              "window_normals_ms": 1e3 * t_wn, "window_normals_median_cos": med_n,
              "window_normals_busy_ms": wn_busy, "sor_ms": 1e3 * t_sor, "sor_busy_ms": sor_busy,
              "sor_kept": kept, "sor_agree": [agree, not_below],
              "soft_fpfh_ms": 1e3 * t_soft, "soft_fpfh_busy_ms": soft_busy,
              "soft_fpfh_peak_gib": peak_soft / 2**30}
    return total, report


def shot_phases(dev, kernels):
    """Phases 15-17: default SHOT and USC on the 1M registration target
    (checked, with their launch counts, times and peak memory) and both on
    2,048 points (the staged exact path). Returns (launches summed over
    the checked 1M runs, numbers for the log)."""
    import threecrate_tpu_torch as tt
    from threecrate_tpu_torch.utils.profiling import device_profile, median_time

    total = dict.fromkeys(kernels.WRAPPERS, 0)
    report = {}

    def normalised(res, dim):
        d = res.descriptors
        norms = d[res.valid].norm(dim=1)
        return (d.shape[1] == dim and bool(torch.isfinite(d).all())
                and bool(((norms - 1).abs() <= 1e-4).all())
                and bool((d[~res.valid] == 0).all()))

    _, tgt_np, _ = registration_pair()
    tgt = tt.PointCloud.from_numpy(tgt_np, device=dev)
    sub = torch.arange(0, N_SCAN, N_SCAN // 16384, device=dev)[:16384]
    nrm = tt.estimate_normals_detailed(tgt).normals     # k = 10, as SHOT estimates them
    fused_cnt = fused_counts(tgt.points, tgt.mask)[sub]
    union = {"union_window_a": 1, "union_window_b": 1}
    shot_once = dict.fromkeys(SHOT_KERNELS, 1)
    for phase, variant, fn, dim, expected in (
            (15, "shot", tt.extract_shot_features, 352, {**union, **shot_once}),
            (16, "usc", tt.extract_usc_features, 128, shot_once)):
        log(f"phase {phase}: {fn.__name__}(target), default settings, on the 1M target")
        res, counts = run_counted(kernels, total, lambda fn=fn: fn(tgt))
        share_v = res.valid.float().sum().item() / N_SCAN
        log(f"  launches {counts}; valid share {share_v:.4f}")
        check(only(counts, expected),
              f"{fn.__name__} did not launch exactly its kernels once each")
        check(res.descriptors.shape[0] == tgt.capacity and normalised(res, dim),
              f"{variant} descriptors not finite, not unit length or not zero where invalid")
        # the staged descriptor over an exact radius search, same normals;
        # where the two ±band windows hold a point's whole neighbourhood
        # (the same count, below the 128 cap) both paths bin the same
        # neighbours, and the JAX package's fused-vs-staged bound holds
        ref, ref_v, ref_cnt = exact_shot(tgt.points, tgt.mask,
                                         nrm if variant == "shot" else torch.zeros_like(nrm),
                                         sub, variant)
        both = ref_v & res.valid[sub]
        fits = both & (fused_cnt == ref_cnt) & (ref_cnt < SHOT_MAX_NEIGHBORS)
        cos = (ref * res.descriptors[sub]).sum(1)
        med, above = cos[both].median().item(), (cos[both] > 0.97).float().mean().item()
        med_fit, n_fit = cos[fits].median().item(), int(fits.sum().item())
        log(f"  cosine vs the staged descriptor over an exact radius search, on the "
            f"{int(both.sum().item())} of 16,384 points valid on both: median {med:.6f}, "
            f"share above 0.97 {above:.4f}; on the {n_fit} whose neighbourhood fits the "
            f"band windows: median {med_fit:.6f} (need >= 0.9 on >= 100), share above "
            f"0.97 {(cos[fits] > 0.97).float().mean().item():.4f}; mean in-radius "
            f"neighbours exact {ref_cnt.float().mean().item():.2f}, in the band windows "
            f"{fused_cnt.float().mean().item():.2f}")
        check(n_fit >= 100 and med_fit >= 0.9,
              f"fused {variant} too far from the staged exact descriptor")
        del res, ref, ref_v, ref_cnt, cos, both, fits
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t = median_time(lambda fn=fn: fn(tgt), warmup=1, iters=3)
        peak = torch.cuda.max_memory_allocated()
        log(f"  {fn.__name__} {1e3 * t:.2f} ms median of 3, peak allocated "
            f"{peak / 2**30:.3f} GiB")
        wall, busy, entries = device_profile(lambda fn=fn: fn(tgt), top=1000)
        log(f"  profiled call: wall {wall:.2f} ms, device busy {busy:.2f} ms, idle share "
            f"{1 - busy / wall:.3f}; largest device entries:")
        for ename, ems, count in entries[:10]:
            log(f"    {ems:9.3f} ms x{count:<4d} {ename[:100]}")
        # the moment merge: pass B written at its pass-A rows, pass A adding
        # them; no inverse-permutation scatter, moment-row gather or add
        index = [(ems, count) for ename, ems, count in entries if "index" in ename.lower()]
        kernel_ms = {ename.split("::")[-1].split("(")[0]: ems
                     for ename, ems, _ in entries if "shot_" in ename}
        log(f"  SHOT kernels' device ms in the profiled call: {json.dumps(kernel_ms)}")
        syncs = host_syncs(lambda fn=fn: fn(tgt))
        log(f"  index kernels (gathers and scatters) of the call: "
            f"{sum(c for _, c in index)} launches, {sum(e for e, _ in index):.3f} ms; "
            f"the moments merge in the kernels (pass B placed at its pass-A rows, pass A "
            f"adding them), with no _inverse scatter, moment-row gather or add; host "
            f"syncs of one call {syncs}")
        report[variant] = {"ms": 1e3 * t, "peak_gib": peak / 2**30, "valid_share": share_v,
                           "median_cos": med, "share_above_0.97": above,
                           "fits": n_fit, "median_cos_fits": med_fit,
                           "profiled_wall_ms": wall, "busy_ms": busy, "host_syncs": syncs,
                           "kernel_ms": kernel_ms,
                           "index_launches": sum(c for _, c in index)}

    log("phase 17: SHOT and USC on 2,048 points (the staged exact path)")
    rng = np.random.default_rng(5)
    xy = rng.uniform(-2, 2, (2048, 2)).astype(np.float32)
    z = 0.4 * np.sin(xy[:, 0] * 2.0) + 0.3 * np.cos(xy[:, 1] * 1.7)
    small = tt.PointCloud.from_numpy(np.stack([xy[:, 0], xy[:, 1], z], -1), device=dev)
    for fn, dim in ((tt.extract_shot_features, 352), (tt.extract_usc_features, 128)):
        kernels.reset_launch_counts()
        res = fn(small)
        counts = kernels.launch_counts()
        share_v = res.valid.float().mean().item()
        log(f"  {fn.__name__}: shape {tuple(res.descriptors.shape)}, valid share "
            f"{share_v:.4f}, launches {counts}")
        check(not any(counts[k] for k in SHOT_KERNELS), "staged path launched a SHOT kernel")
        check(res.descriptors.shape[0] == small.capacity and normalised(res, dim)
              and share_v > 0.9, f"2,048-point {fn.__name__} descriptors wrong")
    return total, report


def angle_deg(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Unsigned angle in degrees between rows of two unit-vector sets."""
    return torch.rad2deg(torch.arccos((a * b).sum(1).abs().clamp(max=1.0)))


def voxel_oracle(pts: np.ndarray, voxel: float):
    """(count, float64 centroids in (z, y, x) key order, each point's
    voxel) of the voxel grid on the same fp32 keys floor((p − min) /
    voxel) as the port."""
    keys = np.floor((pts - pts.min(0)) / np.float32(voxel)).astype(np.int64)
    uniq, inv = np.unique(keys[:, ::-1], axis=0, return_inverse=True)
    inv = inv.reshape(-1)
    cnt = np.bincount(inv)
    cent = np.stack([np.bincount(inv, weights=pts[:, r].astype(np.float64)) / cnt
                     for r in range(3)], 1)
    return len(uniq), cent, inv


def window_fast_phases(dev, kernels):
    """Phases 18-22: ``method="window_fast"`` normals, the voxel grid,
    point-to-plane and multiscale ICP on the 1M scan (pair), then the same
    entries on 2,048 points. Returns (launches summed over the checked 1M
    runs of phases 18, 20 and 21, numbers for the log)."""
    import threecrate_tpu_torch as tt
    from threecrate_tpu_torch.ops import neighbors, registration
    from threecrate_tpu_torch.ops.normals import _pca_normals, default_viewpoint
    from threecrate_tpu_torch.utils.profiling import device_profile, median_time

    total = dict.fromkeys(kernels.WRAPPERS, 0)
    report = {}

    def run(fn):
        return run_counted(kernels, total, fn)

    def timed(fn):
        """(median ms of 3 after one warm-up, peak allocated GiB)."""
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t = median_time(fn, warmup=1, iters=3)
        return 1e3 * t, torch.cuda.max_memory_allocated() / 2**30

    log("phase 18: estimate_normals_detailed(method='window_fast') on the 1M scan")
    pts = scan(N_SCAN, 0)
    pc = tt.PointCloud.from_numpy(pts, device=dev)
    cfg = tt.NormalEstimationConfig(method="window_fast")
    res, counts = run(lambda: tt.estimate_normals_detailed(pc, cfg))
    v_share = res.valid.float().sum().item() / N_SCAN
    norms = res.normals[res.valid].norm(dim=1)
    # exact k = 10 normals of a strided subset: neighbors.knn candidates,
    # distances recomputed as direct differences (its d^2 expands
    # |q|^2 + |p|^2 - 2q.p, ~1e-3 m^2 off at 100 m), the 10 nearest, PCA
    sub = torch.arange(0, N_SCAN, N_SCAN // 16384, device=dev)[:16384]
    q = pc.points[sub]
    cand = neighbors.knn(pc.points, pc.mask, q, None, 16)
    d = torch.where(cand.mask, (pc.points[cand.indices] - q[:, None]).norm(dim=-1), torch.inf)
    d, order = torch.sort(d, dim=1)
    idx = torch.gather(cand.indices, 1, order)[:, :10]
    ok = torch.isfinite(d[:, :10])
    exact_n, exact_c = _pca_normals(pc.points[idx], ok, q, default_viewpoint(pc), True)
    union = tt.estimate_normals_detailed(pc)
    ang_w, ang_u = (angle_deg(exact_n, r.normals[sub]) for r in (res, union))
    both = res.valid[sub] & union.valid[sub] & (ok.sum(1) >= 3)
    planar = both & (exact_c < PLANAR_CURVATURE)
    mean_w, mean_u = ang_w[both].mean().item(), ang_u[both].mean().item()
    mean_planar = ang_w[planar].mean().item()
    # the JAX package's own window_fast quality test on the card: its
    # 20,000-point disc (tests/test_normals.py, seed 7) against exact normals
    rng = np.random.default_rng(7)
    ang = rng.uniform(0, 2 * np.pi, 20000)
    rad = np.abs(rng.normal(0, 25, 20000)) + 2
    disc = tt.PointCloud.from_numpy(np.stack([rad * np.cos(ang), rad * np.sin(ang),
                                              rng.normal(0, 0.05, 20000)], -1), device=dev)
    d_fast = tt.estimate_normals_detailed(disc, cfg)
    d_exact = tt.estimate_normals_detailed(disc, tt.NormalEstimationConfig(method="exact"))
    d_both = d_fast.valid & d_exact.valid
    mean_disc = angle_deg(d_exact.normals, d_fast.normals)[d_both].mean().item()
    log(f"  launches {counts}; valid share {v_share:.5f} (need > 0.99); mean angle to exact "
        f"k=10 normals on a strided subset ({int(both.sum().item())} of 16,384 points): "
        f"window_fast {mean_w:.4f} deg, default union {mean_u:.4f} (need window_fast <= union "
        f"+ 0.5), on the {int(planar.sum().item())} with a planar exact neighbourhood "
        f"(curvature < {PLANAR_CURVATURE}) {mean_planar:.4f} (need < 0.5); the JAX test's "
        f"20,000-point disc: {mean_disc:.4f} deg on {d_both.float().mean().item():.4f} valid "
        f"(need < 0.5)")
    check(only(counts, {"window_normals": 2}), "window_fast did not launch window_normals twice")
    check(v_share > 0.99 and bool(((norms - 1).abs() < 1e-3).all()),
          "window_fast normals: fewer than 99% valid or not unit length")
    check(mean_w <= mean_u + 0.5 and mean_planar < 0.5 and mean_disc < 0.5,
          "window_fast normals too far from the exact ones")
    one = tt.NormalEstimationConfig(method="window_fast", window_passes=1)
    res1, counts1 = run(lambda: tt.estimate_normals_detailed(pc, one))
    log(f"  window_passes=1: launches {counts1}; valid share "
        f"{res1.valid.float().sum().item() / N_SCAN:.5f}")
    check(only(counts1, {"window_normals": 1}), "window_passes=1 did not launch once")
    del res, res1, union, norms, cand, d, idx, ok, exact_n, exact_c
    t2, peak2 = timed(lambda: tt.estimate_normals_detailed(pc, cfg))
    t1, peak1 = timed(lambda: tt.estimate_normals_detailed(pc, one))
    wall, busy, entries = device_profile(lambda: tt.estimate_normals_detailed(pc, cfg))
    log(f"  window_fast {t2:.2f} ms median of 3 ({N_SCAN / t2 / 1e3:.1f} Mpts/s), peak "
        f"{peak2:.3f} GiB; window_passes=1 {t1:.2f} ms ({N_SCAN / t1 / 1e3:.1f} Mpts/s), peak "
        f"{peak1:.3f} GiB; profiled call: wall {wall:.2f} ms, device busy {busy:.2f} ms, "
        f"idle share {1 - busy / wall:.3f}; largest device entries:")
    for ename, ems, count in entries:
        log(f"    {ems:9.3f} ms x{count:<4d} {ename[:100]}")
    report["window_fast"] = {"ms": t2, "peak_gib": peak2, "passes1_ms": t1,
                             "valid_share": v_share, "mean_angle_deg": [mean_w, mean_u],
                             "planar_mean_angle_deg": mean_planar,
                             "disc_mean_angle_deg": mean_disc,
                             "profiled_wall_ms": wall, "busy_ms": busy}

    log(f"phase 19: voxel_grid_filter(cloud, {VOXEL}) on the 1M scan")
    vres, counts = run(lambda: tt.voxel_grid_filter(pc, VOXEL))
    n_vox, cent, inv = voxel_oracle(pts, VOXEL)
    got_n = int(vres.mask.sum().item())
    err = float(np.abs(vres.points[:n_vox].cpu().numpy() - cent).max()) if got_n == n_vox \
        else float("inf")
    det = tt.voxel_grid_filter_detailed(pc, VOXEL)
    inv_ok = bool(np.array_equal(det.voxel_index[:N_SCAN].cpu().numpy(), inv))
    log(f"  launches {counts}; voxels {got_n}, float64 oracle {n_vox}; centroid max abs err "
        f"{err:.3e} m (tol {VOXEL_TOL}); detailed: {int(det.num_voxels)} voxels, inverse "
        f"equal to the oracle's {inv_ok}")
    check(not any(counts.values()), "the voxel grid launched a kernel")
    check(got_n == n_vox and err <= VOXEL_TOL, "voxel grid disagrees with the oracle")
    check(int(det.num_voxels) == n_vox and inv_ok, "voxel grid inverse map wrong")
    del vres, det, cent, inv
    tv, peakv = timed(lambda: tt.voxel_grid_filter(pc, VOXEL))
    log(f"  voxel_grid_filter {tv:.2f} ms median of 3 ({N_SCAN / tv / 1e3:.1f} Mpts/s), peak "
        f"{peakv:.3f} GiB")
    report["voxel"] = {"ms": tv, "peak_gib": peakv, "voxels": n_vox, "centroid_err_m": err}

    log("phase 20: icp_point_to_plane on the 1M scan pair (20 iterations, convergence 0)")
    tgt = tt.PointCloud.from_numpy(pts + SHIFT, device=dev)
    tgt = tgt.with_normals(tt.estimate_normals_detailed(tgt).normals)
    rows = []       # payload rows each static-sort setup packs for icp_match
    real = registration._static_corr_setup

    def spy(*args, **kwargs):
        extra = kwargs.get("tgt_extra")
        rows.append(0 if extra is None else extra.shape[1])
        return real(*args, **kwargs)

    p2pl = dict(max_iterations=20, convergence_threshold=0.0, max_correspondence_distance=1e9)
    registration._static_corr_setup = spy
    try:
        ires, counts = run(lambda: registration.icp_point_to_plane(pc, tgt, **p2pl))
    finally:
        registration._static_corr_setup = real
    t = ires.transformation.cpu().numpy()
    log(f"  launches {counts} with payload rows {sorted(set(rows))}; translation "
        f"{t[:3, 3].tolist()}; iterations {ires.iterations}; mse {ires.mse.item():.3e}")
    check(np.isfinite(t).all() and np.abs(t[:3, 3] - SHIFT).max() <= 1e-3
          and np.abs(t[:3, :3] - np.eye(3)).max() <= 1e-3,
          "point-to-plane did not recover the shift")
    check(only(counts, {"icp_match": counts["icp_match"]})
          and 1 <= counts["icp_match"] <= 20 and set(rows) == {3},
          "point-to-plane did not launch icp_match with 3 payload rows, 1-20 times")
    tp, peakp = timed(lambda: registration.icp_point_to_plane(pc, tgt, **p2pl))
    p2pl_busy = busy_time(lambda: registration.icp_point_to_plane(pc, tgt, **p2pl))
    log(f"  icp_point_to_plane {tp:.2f} ms median of 3, {tp / ires.iterations:.3f} ms per "
        f"iteration, peak {peakp:.3f} GiB, device busy {p2pl_busy:.2f} ms")
    report["point_to_plane"] = {"ms": tp, "ms_per_iteration": tp / ires.iterations,
                                "peak_gib": peakp, "busy_ms": p2pl_busy}

    log("phase 21: multiscale_icp_point_to_point on the 1M scan pair, default config")
    mres, counts = run(lambda: tt.multiscale_icp_point_to_point(pc, tgt))
    t = mres.transformation.cpu().numpy()
    log(f"  launches {counts}; translation {t[:3, 3].tolist()}; final iterations "
        f"{mres.iterations}; mse {mres.mse.item():.3e}")
    check(np.isfinite(t).all() and np.abs(t[:3, 3] - SHIFT).max() <= 1e-3
          and np.abs(t[:3, :3] - np.eye(3)).max() <= 1e-3,
          "multiscale ICP did not recover the shift")
    check(only(counts, {"icp_match": counts["icp_match"]}) and counts["icp_match"] >= 1,
          "multiscale ICP launched another kernel than icp_match")
    tm, peakm = timed(lambda: tt.multiscale_icp_point_to_point(pc, tgt))
    log(f"  multiscale_icp_point_to_point {tm:.2f} ms median of 3, peak {peakm:.3f} GiB")
    report["multiscale"] = {"ms": tm, "peak_gib": peakm}
    del pc, tgt

    log("phase 22: window_fast, point-to-plane and the voxel grid on 2,048 points")
    rng = np.random.default_rng(6)
    xy = rng.uniform(-2, 2, (2048, 2)).astype(np.float32)
    z = 0.4 * np.sin(xy[:, 0] * 2.0) + 0.3 * np.cos(xy[:, 1] * 1.7)
    small = np.stack([xy[:, 0], xy[:, 1], z], -1).astype(np.float32)
    spc = tt.PointCloud.from_numpy(small, device=dev)
    kernels.reset_launch_counts()
    sres = tt.estimate_normals_detailed(spc, cfg)
    counts = kernels.launch_counts()
    s_norms = sres.normals[sres.valid].norm(dim=1)
    log(f"  window_fast: launches {counts}, valid share {sres.valid.float().mean().item():.4f}")
    check(only(counts, {"window_normals": 2}), "2,048-point window_fast did not launch twice")
    check(sres.valid.float().mean().item() > 0.99 and bool(((s_norms - 1).abs() < 1e-3).all()),
          "2,048-point window_fast normals wrong")
    shift = np.array([0.03, -0.01, 0.02], np.float32)
    stgt = tt.PointCloud.from_numpy(small + shift, device=dev)
    stgt = stgt.with_normals(tt.estimate_normals_detailed(stgt).normals)
    kernels.reset_launch_counts()
    pres = registration.icp_point_to_plane(spc, stgt, max_iterations=30)
    vsm = tt.voxel_grid_filter(spc, 0.1)
    counts = kernels.launch_counts()
    t = pres.transformation.cpu().numpy()
    n_small = voxel_oracle(small, 0.1)[0]
    log(f"  point-to-plane translation {t[:3, 3].tolist()}; voxels {int(vsm.mask.sum().item())} "
        f"(oracle {n_small}); launches {counts}")
    check(not any(counts.values()), "the 2,048-point exact paths launched a kernel")
    check(np.abs(t[:3, 3] - shift).max() <= 5e-3, "2,048-point point-to-plane failed")
    check(int(vsm.mask.sum().item()) == n_small, "2,048-point voxel count wrong")
    return total, report


def yaw_pose(yaw: float, t) -> np.ndarray:
    """(4, 4) pose: a rotation ``yaw`` about z, then the translation ``t``."""
    c, s_ = np.cos(yaw), np.sin(yaw)
    m = np.eye(4)
    m[:3, :3] = [[c, -s_, 0], [s_, c, 0], [0, 0, 1]]
    m[:3, 3] = t
    return m


def odometry_frames():
    """Phase 26's frames: (points in the sensor's frame, the sensor's true
    world pose (4, 4)) of ``scan(1M, 0)`` seen from a sensor that starts
    at the origin and moves ODOMETRY_STEP a frame."""
    pts = scan(N_SCAN, 0)
    step = yaw_pose(ODOMETRY_STEP[1], [ODOMETRY_STEP[0], 0.0, 0.0])
    truth = np.eye(4)
    for _ in range(ODOMETRY_FRAMES):
        inv = np.linalg.inv(truth)
        yield (pts @ inv[:3, :3].T + inv[:3, 3]).astype(np.float32), truth
        truth = truth @ step


def pose_errors(pose: np.ndarray, truth: np.ndarray):
    """(max translation error in m, rotation error in rad) of a pose;
    the angle from ‖R − I‖_F = 2√2·sin(θ/2), exact at small angles."""
    r = pose[:3, :3].astype(np.float64).T @ truth[:3, :3]
    theta = 2.0 * np.arcsin(min(np.linalg.norm(r - np.eye(3)) / (2.0 * np.sqrt(2.0)), 1.0))
    return float(np.abs(pose[:3, 3] - truth[:3, 3]).max()), float(theta)


def wavy_depth() -> np.ndarray:
    """bench.py's 480x640 depth image (m)."""
    yy, xx = np.mgrid[0:DEPTH_HW[0], 0:DEPTH_HW[1]]
    return (2.0 + 0.3 * np.sin(xx / 60.0) * np.cos(yy / 45.0)).astype(np.float32)


def shifted_pose(dx: float) -> np.ndarray:
    """The identity moved ``dx`` m along x (float32)."""
    m = np.eye(4, dtype=np.float32)
    m[0, 3] = dx
    return m


def rot_xyz(rx: float, ry: float, rz: float) -> np.ndarray:
    """float64 rotation Rz·Ry·Rx."""
    cx, sx, cy, sy, cz, sz = np.cos(rx), np.sin(rx), np.cos(ry), np.sin(ry), np.cos(rz), np.sin(rz)
    rot_x = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    rot_y = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    rot_z = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    return rot_z @ rot_y @ rot_x


def wall_z(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    return 2.0 + 0.2 * np.sin(x / 0.3) * np.cos(y / 0.25)


def wall_depth(pose: np.ndarray) -> np.ndarray:
    """The wavy wall's depth image seen from ``pose`` (float64 (4, 4)),
    each pixel ray intersected by 48 bisection steps in float64. The
    wall's slopes (at most 0.67 and 0.8) keep every ray of this camera
    crossing it once, so [0.5, 4] m brackets that one crossing. The ray's
    camera-frame direction has z = 1, so its parameter is the depth."""
    h, w = DEPTH_HW
    fx, fy, cx, cy = DEPTH_INTR.astype(np.float64)
    v, u = np.mgrid[0:h, 0:w].astype(np.float64)
    d = np.stack([(u - cx) / fx, (v - cy) / fy, np.ones_like(u)], -1) @ pose[:3, :3].T
    o = pose[:3, 3]
    lo, hi = np.full((h, w), 0.5), np.full((h, w), 4.0)
    for _ in range(48):
        mid = 0.5 * (lo + hi)
        p = o + mid[..., None] * d
        front = p[..., 2] < wall_z(p[..., 0], p[..., 1])
        lo, hi = np.where(front, mid, lo), np.where(front, hi, mid)
    return (0.5 * (lo + hi)).astype(np.float32)


def wall_frames():
    """Phase 31's frames: (depth image, the sensor's true pose (4, 4))
    from a sensor that starts at the identity and moves F2M_STEP a frame."""
    step = np.eye(4)
    step[:3, :3] = rot_xyz(*F2M_STEP[0])
    step[:3, 3] = F2M_STEP[1]
    truth = np.eye(4)
    for _ in range(F2M_FRAMES):
        yield wall_depth(truth), truth
        truth = truth @ step


def track_scene(tt, dev):
    """Phase 30's inputs with the port on ``dev``: bench.py's frame fused
    into the sparse 256^3 volume, the model raycast from the identity and
    the frame's depth raycast from the pose moved TRACK_SHIFT m in x."""
    eye = np.eye(4, dtype=np.float32)
    vol = tt.sparse_tsdf_integrate(
        tt.create_sparse_tsdf_volume(TSDF_VOXEL, origin=TSDF_ORIGIN, grid_blocks=TSDF_GRID,
                                     max_blocks=TSDF_MAX_BLOCKS, device=dev),
        wavy_depth(), DEPTH_INTR, eye, grid_blocks=TSDF_GRID)
    ray = dict(grid_blocks=TSDF_GRID, near=RAY_NEAR, far=RAY_FAR)
    model = tt.sparse_tsdf_raycast(vol, DEPTH_INTR, eye, *DEPTH_HW, **ray)
    frame = tt.sparse_tsdf_raycast(vol, DEPTH_INTR, shifted_pose(TRACK_SHIFT), *DEPTH_HW, **ray)
    return vol, model, frame.depth


def registration_family_phases(dev, kernels):
    """Phases 23-26: GICP, Patchwork++, NDT and ``OdometryModel`` through
    their public entries at full size, each run checked with its launch
    counts (a reset just before, a read just after), then timed. Returns
    (launches summed over the checked runs, numbers for the log)."""
    import threecrate_tpu_torch as tt
    from threecrate_tpu_torch.ops import gicp as gicp_mod
    from threecrate_tpu_torch.ops import ndt as ndt_mod
    from threecrate_tpu_torch.utils.profiling import median_time

    total = dict.fromkeys(kernels.WRAPPERS, 0)
    report = {}

    def run(fn):
        return run_counted(kernels, total, fn)

    def timed(fn):
        """(median ms of 3 after one warm-up, peak allocated GiB, busy ms)."""
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t = median_time(fn, warmup=1, iters=3)
        peak = torch.cuda.max_memory_allocated() / 2**30
        return 1e3 * t, peak, busy_time(fn)

    log("phase 23: gicp(source, target, GicpConfig(max_iterations=10)) on the 1M scan pair")
    pts = scan(N_SCAN, 0)
    src = tt.PointCloud.from_numpy(pts, device=dev)
    tgt = tt.PointCloud.from_numpy(pts + SHIFT, device=dev)
    cfg = tt.GicpConfig(max_iterations=10)
    rows = []       # payload rows each static-sort setup packs for icp_match
    real = gicp_mod._static_corr_setup

    def spy(*args, **kwargs):
        rows.append(kwargs["tgt_extra"].shape[1])
        return real(*args, **kwargs)

    gicp_mod._static_corr_setup = spy
    try:
        res, counts = run(lambda: gicp_mod.gicp(src, tgt, cfg))
    finally:
        gicp_mod._static_corr_setup = real
    t = res.transformation.cpu().numpy()
    t_err, r_err = pose_errors(t, yaw_pose(0.0, SHIFT))
    log(f"  launches {counts} with payload rows {rows}; translation {t[:3, 3].tolist()} (error "
        f"{t_err:.3e} m, tol 1e-3), rotation {r_err:.3e} rad (tol 1e-3); iterations "
        f"{res.iterations}, converged {res.converged}, mse {res.mse.item():.3e}, "
        f"correspondences {res.correspondences}")
    check(np.isfinite(t).all() and t_err <= 1e-3 and r_err <= 1e-3,
          "GICP did not recover the shift")
    check(only(counts, {"union_window_a": 2, "union_window_b": 2,
                        "icp_match": res.iterations}) and set(rows) == {6},
          "GICP did not launch each union kernel twice and icp_match once an iteration "
          "with six payload rows")
    # the convergence test off, so each run takes exactly n iterations; the
    # first counted call also counts a one-time initialisation, so 6 twice
    syncs = {n: host_syncs(lambda n=n: gicp_mod.gicp(
        src, tgt, tt.GicpConfig(max_iterations=n, convergence_threshold=0.0)))
        for n in (6, 6, 10)}
    per_it = (syncs[10] - syncs[6]) / 4
    tg, peak, busy = timed(lambda: gicp_mod.gicp(src, tgt, cfg))
    log(f"  gicp {tg:.2f} ms median of 3, peak {peak:.3f} GiB, device busy {busy:.2f} ms; host "
        f"syncs {syncs[10]} at 10 iterations, {syncs[6]} at 6: {per_it:.2f} an iteration")
    check(per_it == 1.0, "GICP syncs the host other than once an iteration")
    report["gicp"] = {"ms": tg, "peak_gib": peak, "busy_ms": busy, "iterations": res.iterations,
                      "launches": {k: v for k, v in counts.items() if v},
                      "syncs_per_iteration": per_it, "translation_err_m": t_err,
                      "rotation_err_rad": r_err}
    del src, tgt, res

    log("phase 24: patchwork_plus_plus on the 1M scan lowered by the sensor height")
    gpts, labels = ground_scan()
    cloud = tt.PointCloud.from_numpy(gpts, device=dev)
    gres, counts = run(lambda: tt.patchwork_plus_plus(cloud))
    got = gres.ground_mask[:N_SCAN].cpu().numpy()
    cpu = tt.patchwork_plus_plus(tt.PointCloud.from_numpy(gpts, device="cpu"))
    agree = float((got == cpu.ground_mask[:N_SCAN].numpy()).mean())
    rec, prec = recall_precision(got, labels)
    n_ok = int(gres.patch_valid.sum().item())
    log(f"  launches {counts}; ground share {got.mean():.4f}, valid patches {n_ok} of "
        f"{gres.patch_valid.numel()}; agreement with the port's CPU run {agree:.6f} (need >= "
        f"0.999); recall {rec:.4f} / precision {prec:.4f} against the labels, the JAX package "
        f"on the CPU {JAX_GROUND_RECALL:.4f} / {JAX_GROUND_PRECISION:.4f} (need within "
        f"{GROUND_GATE})")
    check(not any(counts.values()), "Patchwork++ launched a kernel")
    check(n_ok > 0 and agree >= 0.999, "Patchwork++ on the card disagrees with the CPU")
    check(abs(rec - JAX_GROUND_RECALL) <= GROUND_GATE
          and abs(prec - JAX_GROUND_PRECISION) <= GROUND_GATE,
          "Patchwork++ recall or precision off the JAX package's")
    tgr, peak, busy = timed(lambda: tt.patchwork_plus_plus(cloud))
    log(f"  patchwork_plus_plus {tgr:.2f} ms median of 3, peak {peak:.3f} GiB, device busy "
        f"{busy:.2f} ms")
    report["ground"] = {"ms": tgr, "peak_gib": peak, "busy_ms": busy, "recall": rec,
                        "precision": prec, "cpu_agreement": agree, "valid_patches": n_ok}
    del cloud, gres, cpu

    log(f"phase 25: ndt_registration on a {NDT_POINTS:,}-point scan pair (2 m cells, 20 "
        f"iterations)")
    npts = scan(NDT_POINTS, 7)
    ncfg = tt.NdtConfig(**NDT_CONFIG)
    out = {}
    for d in (dev, torch.device("cpu")):
        s_pc = tt.PointCloud.from_numpy(npts, device=d)
        t_pc = tt.PointCloud.from_numpy(npts + SHIFT, device=d)
        out[d.type] = (s_pc, t_pc) + run(lambda: ndt_mod.ndt_registration(s_pc, t_pc, ncfg))
    s_pc, t_pc, nres, counts = out[dev.type]
    t = nres.transformation.cpu().numpy()
    d_cpu = float(np.abs(t - out["cpu"][2].transformation.numpy()).max())
    t_err = float(np.abs(t[:3, 3] - SHIFT).max())
    d_jax = float(np.abs(t[:3, 3] - JAX_NDT_TRANSLATION).max())
    log(f"  launches {counts}; translation {t[:3, 3].tolist()}: {t_err:.3e} m off the applied "
        f"shift, {d_jax:.3e} m off the JAX package's on the CPU {JAX_NDT_TRANSLATION} (tol "
        f"1e-3); iterations {nres.iterations}, score {nres.score.item():.2f}; against the "
        f"port's CPU run {d_cpu:.3e} (tol 1e-4)")
    check(not any(counts.values()), "NDT launched a kernel")
    check(np.isfinite(t).all() and d_jax <= 1e-3 and d_cpu <= 1e-4,
          "NDT disagrees with the JAX package's result or the port's CPU run")
    sub = tt.ops.registration.auto_subsample(s_pc.capacity)
    tn, peak, busy = timed(lambda: ndt_mod.ndt_registration(s_pc, t_pc, ncfg))
    gauss = ndt_mod.build_gaussians(t_pc.points, t_pc.mask, ncfg.resolution,
                                    ncfg.min_points_per_voxel)
    t_build = 1e3 * median_time(lambda: ndt_mod.build_gaussians(
        t_pc.points, t_pc.mask, ncfg.resolution, ncfg.min_points_per_voxel), warmup=1, iters=3)
    t_loop = 1e3 * median_time(lambda: ndt_mod._ndt_loop(
        s_pc.points, s_pc.mask, gauss, torch.eye(4), ncfg.max_iterations, ncfg.step_size,
        ncfg.epsilon, subsample=sub, full_iters=ncfg.full_iters), warmup=1, iters=3)
    log(f"  ndt_registration {tn:.2f} ms median of 3 (build {t_build:.2f} ms, loop {t_loop:.2f} "
        f"ms, subsample {sub}), peak {peak:.3f} GiB, device busy {busy:.2f} ms")
    report["ndt"] = {"ms": tn, "build_ms": t_build, "loop_ms": t_loop, "peak_gib": peak,
                     "busy_ms": busy, "translation_err_m": t_err, "jax_diff_m": d_jax,
                     "cpu_diff": d_cpu}
    del out, s_pc, t_pc, gauss

    log(f"phase 26: OdometryModel() over {ODOMETRY_FRAMES} frames of the 1M scan, the sensor "
        f"moving {ODOMETRY_STEP[0]} m and {ODOMETRY_STEP[1]} rad of yaw a frame")
    model = tt.OdometryModel()
    frame_ms, icp_launches, errs = [], [], []
    for pts_f, truth in odometry_frames():
        frame = tt.PointCloud.from_numpy(pts_f, device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pose, counts = run(lambda: model.step(frame))
        frame_ms.append(1e3 * (time.perf_counter() - t0))
        icp_launches.append(counts["icp_match"])
        errs.append(pose_errors(pose.matrix.cpu().numpy(), truth))
        check(only(counts, {"icp_match": counts["icp_match"]}),
              "odometry launched another kernel than icp_match")
    map_valid = int(model.local_map.mask.sum().item())
    log(f"  pose errors (m, rad) {errs} (tol {ODOMETRY_TOL}); icp_match launches a frame "
        f"{icp_launches}; ms a frame {[round(x, 2) for x in frame_ms]}; map {map_valid} valid "
        f"of {model.local_map.capacity}")
    check(all(e[0] <= ODOMETRY_TOL[0] and e[1] <= ODOMETRY_TOL[1] for e in errs),
          "odometry poses off the truth")
    check(all(n >= 1 for n in icp_launches[1:]), "odometry frames did not launch icp_match")
    report["odometry"] = {"ms_per_frame_after_first": float(np.mean(frame_ms[1:])),
                          "icp_match_launches": icp_launches, "pose_errors": errs,
                          "map_valid": map_valid, "map_capacity": model.local_map.capacity}
    return total, report


def depth_camera_phases(dev, kernels):
    """Phases 27-31: the depth-camera slice (no kernel of its own) through
    its public entries at bench.py's sizes, each run with the launch
    counters reset just before and read just after, checked, then timed:
    median of 3 after a warm-up (CUDA events), peak memory, device busy
    time and host syncs. Returns (launches, numbers for the log)."""
    import threecrate_tpu_torch as tt
    from threecrate_tpu_torch.ops import frame_to_model as f2m_mod
    from threecrate_tpu_torch.ops import tsdf as tsdf_mod
    from threecrate_tpu_torch.ops import tsdf_raycast as ray_mod
    from threecrate_tpu_torch.utils.profiling import median_time

    total = dict.fromkeys(kernels.WRAPPERS, 0)
    report = {"card": card_line()}
    cpu = torch.device("cpu")
    h, w = DEPTH_HW

    def run(fn):
        out, counts = run_counted(kernels, total, fn)
        check(not any(counts.values()), "the depth-camera slice launched a kernel")
        return out

    def cpu_run(fn):
        t0 = time.perf_counter()
        out = fn()
        return out, 1e3 * (time.perf_counter() - t0)

    def fmt(m):
        return (f"{m['ms']:.2f} ms median of 3, peak {m['peak_gib']:.3f} GiB, device busy "
                f"{m['busy_ms']:.2f} ms, {m['host_syncs']} host syncs ({report['card']})")

    depth_np, eye_np = wavy_depth(), np.eye(4, dtype=np.float32)
    depth, intr, eye = (torch.from_numpy(x).to(dev) for x in (depth_np, DEPTH_INTR, eye_np))

    log(f"phase 27: tsdf_integrate of the {h}x{w} frame into a {TSDF_RES}^3 volume "
        f"({TSDF_VOXEL} m voxels), then tsdf_extract_surface_banded")
    res3 = (TSDF_RES,) * 3
    vol0 = tt.create_tsdf_volume(res3, TSDF_VOXEL, origin=TSDF_ORIGIN, device=dev)
    dense = run(lambda: tt.tsdf_integrate(vol0, depth, intr, eye))
    dense_cpu, cpu_ms = cpu_run(lambda: tt.tsdf_integrate(
        tt.create_tsdf_volume(res3, TSDF_VOXEL, origin=TSDF_ORIGIN, device=cpu), depth_np,
        DEPTH_INTR, eye_np))
    pix = [tsdf_mod._project(tsdf_mod._voxel_centers(v), i, p, h, w)[:2]
           for v, i, p in ((dense, intr, eye), (dense_cpu, intr.cpu(), eye.cpu()))]
    same_pix = (pix[0][0].cpu() == pix[1][0]) & (pix[0][1].cpu() == pix[1][1])
    del pix
    pix_share = same_pix.float().mean().item()
    w_share = (dense.weight.cpu() == dense_cpu.weight).float().mean().item()
    tsdf_err = (dense.tsdf.cpu() - dense_cpu.tsdf)[same_pix].abs().max().item()
    observed = int((dense.weight > 0).sum().item())
    m27 = measure(lambda: tt.tsdf_integrate(vol0, depth, intr, eye))
    surf = run(lambda: tt.tsdf_extract_surface_banded(dense))
    pts = surf.cloud.points[surf.cloud.mask]
    ui, vi, in_img, _ = tsdf_mod._project(pts, intr, eye, h, w)
    surf_err = (pts[:, 2] - depth[vi, ui])[in_img].abs().max().item()
    in_share = in_img.float().mean().item()
    m27s = measure(lambda: tt.tsdf_extract_surface_banded(dense))
    log(f"  {observed} voxels observed; same pixel on card and CPU {pix_share:.7f} (need >= "
        f"{PIXEL_SHARE}), weight equal {w_share:.7f}, tsdf max |diff| {tsdf_err:.3e} where both "
        f"pick the same pixel (tol 1e-6); CPU run {cpu_ms:.1f} ms; {int(surf.count)} surface "
        f"points, {in_share:.5f} inside the image, max |z - depth| {surf_err:.3e} m (tol one "
        f"voxel, {TSDF_VOXEL})")
    log(f"  integrate {fmt(m27)}")
    log(f"  extract_surface_banded {fmt(m27s)}")
    check(observed > 0.02 * TSDF_RES ** 3 and pix_share >= PIXEL_SHARE and tsdf_err <= 1e-6,
          "dense fusion on the card disagrees with the CPU run")
    check(int(surf.count) > 0.1 * TSDF_RES ** 2 and in_share >= 0.99 and surf_err <= TSDF_VOXEL,
          "surface points off the input depth")
    report["tsdf_integrate"] = {**m27, "pixel_share": pix_share, "weight_share": w_share,
                                "tsdf_err": tsdf_err, "cpu_ms": cpu_ms}
    report["tsdf_extract_surface_banded"] = {**m27s, "points": int(surf.count),
                                             "depth_err_m": surf_err}
    del vol0, dense_cpu, same_pix, surf, pts, ui, vi, in_img

    log(f"phase 28: sparse_tsdf_integrate, {TSDF_GRID} blocks of 8, max_blocks "
        f"{TSDF_MAX_BLOCKS}, without and with colour")
    rgb_np = np.tile(np.linspace(0, 1, w, dtype=np.float32)[None, :, None], (h, 1, 3))
    rgb = torch.from_numpy(rgb_np).to(dev)
    sparse = {}
    for color in (False, True):
        def empty(d, cap=TSDF_MAX_BLOCKS):
            return tt.create_sparse_tsdf_volume(TSDF_VOXEL, origin=TSDF_ORIGIN,
                                                grid_blocks=TSDF_GRID, max_blocks=cap,
                                                with_color=color, device=d)
        kw = dict(grid_blocks=TSDF_GRID, rgb=rgb if color else None)
        svol = run(lambda: tt.sparse_tsdf_integrate(empty(dev), depth, intr, eye, **kw))
        scpu, cpu_ms = cpu_run(lambda: tt.sparse_tsdf_integrate(
            empty(cpu), depth_np, DEPTH_INTR, eye_np, grid_blocks=TSDF_GRID,
            rgb=rgb_np if color else None))
        attempted = int(tt.sparse_tsdf_integrate(empty(dev, TSDF_GRID[0] ** 3), depth, intr,
                                                 eye, **kw).n_blocks)
        n = int(svol.n_blocks)
        keys_equal = n == int(scpu.n_blocks) and torch.equal(svol.block_keys.cpu(),
                                                             scpu.block_keys)
        same = svol.weight.cpu() == scpu.weight
        share = same.float().mean().item()
        err = (svol.tsdf.cpu() - scpu.tsdf)[same].abs().max().item()
        if color:
            err = max(err, (svol.color.cpu() - scpu.color)[same].abs().max().item())
        # allocated interiors against phase 27's dense volume
        sd = tt.sparse_tsdf_to_dense(svol, TSDF_GRID)
        both = (sd.weight > 0) & (dense.weight > 0)
        dense_err = (sd.tsdf - dense.tsdf)[both].abs().max().item()
        dense_w = torch.equal(sd.weight[both], dense.weight[both])
        m28 = measure(lambda: tt.sparse_tsdf_integrate(svol, depth, intr, eye, **kw))
        name = "sparse_integrate" + (" color" if color else "")
        log(f"  {name}: {n} blocks allocated of {attempted} attempted (capacity "
            f"{TSDF_MAX_BLOCKS}, overflow {max(attempted - n, 0)}); keys equal to the CPU run "
            f"{keys_equal}; weight equal {share:.7f}, max |diff| {err:.3e} where equal (tol "
            f"1e-6); against phase 27's dense volume on {int(both.sum().item())} voxels: tsdf "
            f"{dense_err:.3e} (tol 1e-5), weights equal {dense_w}; CPU run {cpu_ms:.1f} ms")
        log(f"  {name} (second frame into the fused volume) {fmt(m28)}")
        check(keys_equal and n > 0.002 * TSDF_GRID[0] ** 3 and share >= PIXEL_SHARE
              and err <= 1e-6,
              f"{name} on the card disagrees with the CPU run")
        check(int(both.sum().item()) > 0.005 * TSDF_RES ** 3 and dense_err <= 1e-5 and dense_w,
              f"{name} disagrees with the dense volume")
        report[name] = {**m28, "blocks": n, "attempted": attempted, "weight_share": share,
                        "cpu_ms": cpu_ms, "dense_err": dense_err}
        sparse[color] = svol
        del scpu, sd, both
    svol = sparse[False]
    del sparse

    log(f"phase 29: sparse_tsdf_raycast {h}x{w} from the identity, near {RAY_NEAR}, far "
        f"{RAY_FAR}; tsdf_raycast of phase 27's volume")
    ray = dict(grid_blocks=TSDF_GRID, near=RAY_NEAR, far=RAY_FAR)
    ray_mod.reset_counts()
    rc = run(lambda: tt.sparse_tsdf_raycast(svol, intr, eye, h, w, **ray))
    rounds = dict(ray_mod.counts)
    rc_rows = run(lambda: tt.sparse_tsdf_raycast(svol, intr, eye, h, w, materialize=False, **ray))
    mask_eq = torch.equal(rc.mask, rc_rows.mask)
    d_err = (rc.depth - rc_rows.depth).abs().max().item()
    n_err = (rc.normals - rc_rows.normals).abs().max().item()
    hit, conf_share = rc.mask.float().mean().item(), rc.confident.float().mean().item()

    def confident_err(res):
        """(max |depth − input| on confident pixels, share beyond half a voxel)."""
        err = (res.depth - depth)[res.confident].abs()
        return err.max().item(), (err > TSDF_VOXEL / 2).float().mean().item()

    depth_err, over_half = confident_err(rc)
    spacing, chosen = {}, ray_mod.EXIT_TEST_EVERY
    for every in (1, 4, 8, 16):
        ray_mod.EXIT_TEST_EVERY = every
        ray_mod.reset_counts()
        tt.sparse_tsdf_raycast(svol, intr, eye, h, w, **ray)
        steps = ray_mod.counts["steps"]
        spacing[every] = {"steps": steps, "ms": 1e3 * median_time(
            lambda: tt.sparse_tsdf_raycast(svol, intr, eye, h, w, **ray), warmup=1, iters=3)}
    ray_mod.EXIT_TEST_EVERY = chosen
    m29 = measure(lambda: tt.sparse_tsdf_raycast(svol, intr, eye, h, w, **ray))
    m29r = measure(lambda: tt.sparse_tsdf_raycast(svol, intr, eye, h, w, materialize=False,
                                                  **ray))
    rd = run(lambda: tt.tsdf_raycast(dense, intr, eye, h, w, near=RAY_NEAR, far=RAY_FAR))
    dense_depth_err, dense_over_half = confident_err(rd)
    m29d = measure(lambda: tt.tsdf_raycast(dense, intr, eye, h, w, near=RAY_NEAR, far=RAY_FAR))
    log(f"  hits {hit:.5f}, confident {conf_share:.5f}; confident depth max |diff| to the input "
        f"{depth_err:.3e} m, {over_half:.5f} of them beyond half a voxel (tol "
        f"{JAX_CONFIDENT_DEPTH_ERR} m and {JAX_CONFIDENT_OVER_HALF}: the JAX package's, rounded "
        f"up); march steps and exit tests "
        f"{rounds} (coarse and full level, a test every {ray_mod.EXIT_TEST_EVERY} steps); the "
        f"row-map path: mask equal {mask_eq}, depth {d_err:.3e} (tol 1e-6), normals {n_err:.3e} "
        f"(tol 1e-5)")
    log(f"  exit test spacing (steps, ms): {json.dumps(spacing)}")
    log(f"  sparse_raycast {fmt(m29)}")
    log(f"  sparse_raycast materialize=False {fmt(m29r)}")
    log(f"  dense raycast: hits {rd.mask.float().mean().item():.5f}, confident depth max |diff| "
        f"{dense_depth_err:.3e} m, {dense_over_half:.5f} beyond half a voxel; {fmt(m29d)}")
    check(mask_eq and d_err <= 1e-6 and n_err <= 1e-5, "the two sparse samplers disagree")
    check(hit > 0.95 and max(depth_err, dense_depth_err) <= JAX_CONFIDENT_DEPTH_ERR
          and max(over_half, dense_over_half) <= JAX_CONFIDENT_OVER_HALF,
          "raycast depth off the input depth")
    report["sparse_raycast"] = {**m29, "hit_share": hit, "confident_share": conf_share,
                                "depth_err_m": depth_err, "over_half_voxel": over_half,
                                "march": rounds, "spacing": spacing}
    report["sparse_raycast rows"] = m29r
    report["raycast dense"] = {**m29d, "depth_err_m": dense_depth_err,
                               "over_half_voxel": dense_over_half}
    del rc, rc_rows, rd, dense

    log(f"phase 30: track_frame_to_model, the frame raycast from the identity moved "
        f"{TRACK_SHIFT} m in x, max_iterations=10")
    _, model, frame_depth = track_scene(tt, dev)
    f2m_mod.reset_counts()
    tr = run(lambda: tt.track_frame_to_model(model, eye, frame_depth, intr, eye,
                                             max_iterations=10))
    iters = f2m_mod.counts["iterations"]
    pose = tr.cam_to_world.cpu().numpy()
    truth = shifted_pose(TRACK_SHIFT)
    d = np.linalg.inv(truth.astype(np.float64)) @ pose
    rot = float(np.arccos(np.clip((np.trace(d[:3, :3]) - 1) / 2, -1, 1)))
    trans = float(np.linalg.norm(d[:3, 3]))
    jax_diff = float(np.abs(pose[:3, 3] - JAX_TRACK_TRANSLATION).max())
    syncs = host_syncs(lambda: tt.track_frame_to_model(model, eye, frame_depth, intr, eye,
                                                       max_iterations=10))
    m30 = measure(lambda: tt.track_frame_to_model(model, eye, frame_depth, intr, eye,
                                                  max_iterations=10))
    log(f"  pose off the truth {rot:.3e} rad (tol 2e-3), {trans:.3e} m (tol half a voxel); "
        f"translation {pose[:3, 3].tolist()}, {jax_diff:.3e} m off the JAX package's on the "
        f"CPU {JAX_TRACK_TRANSLATION} (tol {TRACK_JAX_TOL}); {iters} iterations, {syncs} host "
        f"syncs ({syncs / iters:.2f} an iteration); n_valid {int(tr.n_valid)}, rmse "
        f"{float(tr.rmse):.3e}")
    log(f"  track {fmt(m30)}")
    check(bool(tr.converged) and rot <= 2e-3 and trans <= TSDF_VOXEL / 2,
          "tracking missed the true pose")
    check(jax_diff <= TRACK_JAX_TOL, "tracking disagrees with the JAX package's pose")
    report["track"] = {**m30, "iterations": iters, "syncs_per_iteration": syncs / iters,
                       "rot_err_rad": rot, "trans_err_m": trans, "jax_diff_m": jax_diff}
    del model, frame_depth, svol

    log(f"phase 31: FrameToModelOdometry() defaults over {F2M_FRAMES} {h}x{w} frames of an "
        f"analytic wavy wall, the sensor moving ~0.01 m and 0.005 rad a frame")
    frames = [(torch.from_numpy(dpt).to(dev), truth) for dpt, truth in wall_frames()]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    odo = tt.FrameToModelOdometry(tt.CameraIntrinsics(*DEPTH_INTR.tolist()), h, w, device=dev)
    frame_ms, errs, iters = [], [], []
    for dpt, truth in frames:
        f2m_mod.reset_counts()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        pose = run(lambda: odo.register_frame(dpt))
        end.record()
        end.synchronize()
        frame_ms.append(start.elapsed_time(end))
        iters.append(f2m_mod.counts["iterations"])
        errs.append(pose_errors(pose.matrix.cpu().numpy(), truth))
    peak = torch.cuda.max_memory_allocated() / 2**30
    # one more frame, profiled and sync-counted, on shallow copies: an
    # update replaces the volume and pose rather than writing into them
    nxt = frames[-1][0]
    busy = busy_time(lambda: copy.copy(odo).register_frame(nxt))
    syncs = host_syncs(lambda: copy.copy(odo).register_frame(nxt))
    worst = (max(e[0] for e in errs), max(e[1] for e in errs))
    log(f"  pose errors (m, rad) {errs} (worst {worst}, tol {F2M_TOL}); ms a frame "
        f"{[round(x, 2) for x in frame_ms]} (after the first: mean "
        f"{np.mean(frame_ms[1:]):.2f}); tracking iterations {iters}; {int(odo.volume.n_blocks)} "
        f"blocks of {odo.volume.max_blocks}; a frame: busy {busy:.2f} ms, {syncs} host syncs; "
        f"peak {peak:.3f} GiB ({report['card']})")
    check(worst[0] <= F2M_TOL[0] and worst[1] <= F2M_TOL[1], "odometry poses off the truth")
    report["odometry"] = {"ms_per_frame_after_first": float(np.mean(frame_ms[1:])),
                          "frame_ms": frame_ms, "pose_errors": errs, "iterations": iters,
                          "busy_ms": busy, "host_syncs": syncs, "peak_gib": peak,
                          "blocks": int(odo.volume.n_blocks)}
    return total, report


def triangle_set(vertices: torch.Tensor, mask: torch.Tensor) -> np.ndarray:
    """A soup's live triangles as a sorted multiset of rows rounded to 5
    decimals (``TestBandedMarchingCubes._soup_set``), picked on the
    device."""
    tri = vertices.reshape(-1, 9)[mask].cpu().numpy()
    return np.sort(np.ascontiguousarray(tri.round(5)).view([("", np.float32)] * 9), axis=None)


def mesh_triangle_set(mesh) -> np.ndarray:
    v, f = mesh.to_numpy()
    return np.sort(np.ascontiguousarray(v[f].round(5).reshape(-1, 9)).view(
        [("", np.float32)] * 9), axis=None)


def surface_phases(dev, kernels):
    """Phases 32-35: the surface-reconstruction slice (no kernel of its
    own) through its entries at bench.py's sizes, each run with the launch
    counters reset just before and read just after, checked, then timed:
    median of 3 after a warm-up (CUDA events), peak memory, device busy
    time and host syncs. Returns (launches, numbers for the log)."""
    import threecrate_tpu_torch as tt
    from threecrate_tpu_torch.reconstruction import multigrid
    from threecrate_tpu_torch.reconstruction import poisson as poisson_mod
    mc = importlib.import_module("threecrate_tpu_torch.reconstruction.marching_cubes")

    total = dict.fromkeys(kernels.WRAPPERS, 0)
    report = {"card": card_line()}
    cpu = torch.device("cpu")

    def run(fn):
        out, counts = run_counted(kernels, total, fn)
        check(not any(counts.values()), "the surface slice launched a kernel")
        return out

    def fmt(m):
        busy = f"device busy {m['busy_ms']:.2f} ms, " if "busy_ms" in m else ""
        return (f"{m['ms']:.2f} ms median of 3, peak {m['peak_gib']:.3f} GiB, {busy}"
                f"{m['host_syncs']} host syncs ({report['card']})")

    t_phase = time.perf_counter()

    def phase_seconds():
        nonlocal t_phase
        t, t_phase = time.perf_counter() - t_phase, time.perf_counter()
        return f"{t:.1f} s"

    depth_np, eye_np = wavy_depth(), np.eye(4, dtype=np.float32)
    depth, intr, eye = (torch.from_numpy(x).to(dev) for x in (depth_np, DEPTH_INTR, eye_np))
    res3 = (TSDF_RES,) * 3
    vol = tt.tsdf_integrate(tt.create_tsdf_volume(res3, TSDF_VOXEL, origin=TSDF_ORIGIN,
                                                  device=dev), depth, intr, eye)
    grid = tt.VolumetricGrid(vol.tsdf, vol.origin, vol.voxel_size)

    log(f"phase 32: extract_soup_cubes of phase 27's {TSDF_RES}^3 volume at iso 0 (dense)")
    dense = run(lambda: mc.extract_soup_cubes(grid, 0.0))
    dense_set = triangle_set(dense.vertices, dense.mask)
    del dense
    m32 = measure(lambda: mc.extract_soup_cubes(grid, 0.0))
    log(f"  {len(dense_set)} live triangles; {fmt(m32)}; phase {phase_seconds()}")

    log(f"phase 33: extract_soup_cubes_banded, block {MC_BLOCK}, cap from _block_active_count")
    n_act = int(run(lambda: mc._block_active_count(grid.values, 0.0, block=MC_BLOCK)))
    n_blocks = math.prod(-(-(n - 1) // MC_BLOCK) for n in grid.values.shape)
    cap = 256
    while cap < n_act:
        cap *= 2
    banded = run(lambda: mc.extract_soup_cubes_banded(grid, 0.0, block=MC_BLOCK,
                                                      max_blocks=cap))
    banded_set = triangle_set(banded.vertices, banded.mask)
    t0 = time.perf_counter()
    grid_cpu = tt.VolumetricGrid(grid.values.cpu(), grid.origin.cpu(), grid.spacing.cpu())
    banded_cpu = mc.extract_soup_cubes_banded(grid_cpu, 0.0, block=MC_BLOCK, max_blocks=cap)
    cpu_ms = 1e3 * (time.perf_counter() - t0)
    mask_eq = torch.equal(banded.mask.cpu(), banded_cpu.mask)
    verts_eq = torch.equal(banded.vertices.cpu(), banded_cpu.vertices)
    same_set = dense_set.shape == banded_set.shape and bool((dense_set == banded_set).all())
    del banded, banded_cpu, dense_set
    m33 = measure(lambda: mc.extract_soup_cubes_banded(grid, 0.0, block=MC_BLOCK,
                                                       max_blocks=cap))
    log(f"  {n_act} active blocks of {n_blocks}, cap {cap}; {len(banded_set)} live triangles; "
        f"the dense soup's triangle multiset {same_set}; against the CPU run ({cpu_ms:.0f} ms): "
        f"mask equal {mask_eq}, vertices bit-equal {verts_eq}; {fmt(m33)}; phase "
        f"{phase_seconds()}")
    check(len(banded_set) > 0.1 * TSDF_RES ** 2 and same_set,
          "banded and dense soups disagree on the card")
    check(mask_eq and verts_eq, "the banded soup on the card differs from the CPU run")
    report["extract_soup_cubes"] = {**m32, "triangles": len(banded_set)}
    report["extract_soup_cubes_banded"] = {**m33, "active_blocks": n_act, "cap": cap,
                                           "blocks": n_blocks, "cpu_ms": cpu_ms}
    del banded_set, grid_cpu

    log("phase 34: marching_cubes through the device and the host weld; the sparse "
        "volume's mesh against the dense one")
    meshes = {w: run(lambda: tt.marching_cubes(grid, 0.0, weld=w)) for w in ("device", "host")}
    counts = {w: (int(m.vertex_count()), int(m.face_count())) for w, m in meshes.items()}
    sets = [mesh_triangle_set(m) for m in meshes.values()]
    welds_eq = counts["device"] == counts["host"] and sets[0].shape == sets[1].shape \
        and bool((sets[0] == sets[1]).all())
    on_card = all(m.vertices.device.type == dev.type for m in meshes.values())
    del meshes, sets
    m34 = {w: measure(lambda: tt.marching_cubes(grid, 0.0, weld=w), profile=w == "device")
           for w in ("device", "host")}
    svol = tt.sparse_tsdf_integrate(
        tt.create_sparse_tsdf_volume(TSDF_VOXEL, origin=TSDF_ORIGIN, grid_blocks=TSDF_GRID,
                                     max_blocks=TSDF_MAX_BLOCKS, device=dev),
        depth, intr, eye, grid_blocks=TSDF_GRID)

    def sparse_mesh():
        return mc.soup_to_mesh(tt.sparse_tsdf_marching_cubes_soup(svol, TSDF_GRID))

    mesh_s = run(sparse_mesh)
    masked = tt.VolumetricGrid(torch.where(vol.weight >= 1.0, vol.tsdf, 1.0),
                               vol.origin + 0.5 * vol.voxel_size, vol.voxel_size)
    mesh_d = run(lambda: tt.marching_cubes(masked, 0.0))
    fd, fs = int(mesh_d.face_count()), int(mesh_s.face_count())
    kd = set(map(tuple, mesh_d.to_numpy()[0].round(4).tolist()))
    ks = set(map(tuple, mesh_s.to_numpy()[0].round(4).tolist()))
    shared = len(kd & ks) / max(len(kd), len(ks), 1)
    m34s = measure(sparse_mesh)
    log(f"  welds: counts (vertices, faces) {counts}, equal triangle multisets {welds_eq}, "
        f"meshes on the card {on_card}; device weld {fmt(m34['device'])}; host weld "
        f"{fmt(m34['host'])}")
    log(f"  sparse: {int(svol.n_blocks)} blocks, {fs} faces against the dense mesh's {fd} (tol "
        f"{SPARSE_MESH_FACES}), {shared:.5f} of rounded vertices shared (need > "
        f"{SPARSE_MESH_SHARED}); sparse soup + weld {fmt(m34s)}; phase {phase_seconds()}")
    check(welds_eq and on_card and counts["host"][1] > 0.1 * TSDF_RES ** 2,
          "device and host welds disagree")
    check(fs > 0 and abs(fd - fs) <= SPARSE_MESH_FACES * fd and shared > SPARSE_MESH_SHARED,
          "the sparse mesh disagrees with the dense one")
    report["marching_cubes device weld"] = {**m34["device"], "vertices": counts["device"][0],
                                            "faces": counts["device"][1]}
    report["marching_cubes host weld"] = m34["host"]
    report["sparse marching cubes + weld"] = {**m34s, "faces": fs, "dense_faces": fd,
                                              "shared": shared}
    del vol, grid, masked, svol, mesh_s, mesh_d, kd, ks

    log(f"phase 35: Poisson, {POISSON_N} points on the unit sphere, {POISSON_RES}^3, "
        "multigrid (8 cycles), then poisson_reconstruct(PoissonConfig(depth=7))")
    pts_np = scan(POISSON_N, 3)
    pts_np = pts_np / np.maximum(np.linalg.norm(pts_np, axis=1, keepdims=True), 1e-9)
    pts = torch.from_numpy(pts_np).to(dev)
    mask = torch.ones(POISSON_N, dtype=torch.bool, device=dev)
    spacing = torch.tensor(2.4 / (POISSON_RES - 1), device=dev)
    origin = torch.full((3,), POISSON_LO, device=dev)
    args = (pts, pts, mask, origin, spacing, POISSON_RES, 200, 1e-4)

    def solve(*a):
        return poisson_mod._solve(*(a or args), solver="multigrid", mg_cycles=8)

    chi, iso, support = run(solve)
    chi2 = solve()[0]
    scale = chi.abs().max().item()
    spread = (chi - chi2).abs().max().item() / scale
    rhs = poisson_mod._splat(*args[:6])[0]
    resid = multigrid.mg_residual_norm(rhs, chi, 1e-4).item()
    t0 = time.perf_counter()
    chi_c, iso_c, support_c = solve(*(a.cpu() if torch.is_tensor(a) else a for a in args))
    cpu_ms = 1e3 * (time.perf_counter() - t0)
    chi_err = (chi.cpu() - chi_c).abs().max().item() / scale
    iso_err = abs(iso.item() - iso_c.item()) / scale
    sup_err = (support.cpu() - support_c).abs().max().item() / support_c.abs().max().item()
    del chi2, rhs, chi_c, support_c
    m35 = measure(solve)
    log(f"  relative residual {resid:.3e}; chi spread over two calls {spread:.3e} of max|chi| "
        f"{scale:.4f}; against the CPU run ({cpu_ms:.0f} ms): chi {chi_err:.3e}, iso "
        f"{iso_err:.3e} of max|chi| (tol {POISSON_CHI_TOL}), support {sup_err:.3e} of its "
        f"max; {fmt(m35)}; {phase_seconds()}")
    check(resid < 1e-3 and chi_err <= POISSON_CHI_TOL and iso_err <= POISSON_CHI_TOL
          and sup_err <= 1e-5, "the Poisson solve on the card disagrees with the CPU run")
    cloud = tt.PointCloud.from_numpy(pts_np, normals=pts_np, device=dev)
    cfg = tt.PoissonConfig(depth=7)
    mesh = run(lambda: tt.poisson_reconstruct(cloud, cfg))
    v, f = mesh.to_numpy()
    r = np.linalg.norm(v, axis=1)
    m35r = measure(lambda: tt.poisson_reconstruct(cloud, cfg), profile=False)
    log(f"  poisson_reconstruct: {len(v)} vertices, {len(f)} faces on "
        f"{mesh.vertices.device.type}; radius median {np.median(r):.5f}, std {r.std():.5f} "
        f"(tol {POISSON_RADIUS_TOL}); {fmt(m35r)}; {phase_seconds()}")
    check(len(f) > 10000 and abs(np.median(r) - 1.0) <= POISSON_RADIUS_TOL
          and r.std() < POISSON_RADIUS_TOL, "the depth-7 Poisson mesh is off the sphere")
    report["poisson _solve multigrid 128^3"] = {
        **m35, "residual": resid, "chi_spread": spread, "chi_err": chi_err, "iso_err": iso_err,
        "cpu_ms": cpu_ms}
    report["poisson_reconstruct depth 7"] = {**m35r, "faces": len(f),
                                             "radius_median": float(np.median(r)),
                                             "radius_std": float(r.std())}
    return total, report


def uv_sphere(n_sub: int, center=(0.0, 0.0, 0.0)):
    """A closed UV sphere of radius 1: n_sub rings of 2·n_sub vertices and
    two poles, 4·n_sub² faces."""
    thetas = np.linspace(0.25, np.pi - 0.25, n_sub)
    phis = np.linspace(0, 2 * np.pi, n_sub * 2, endpoint=False)
    m = len(phis)
    v = np.stack([np.outer(np.sin(thetas), np.cos(phis)).ravel(),
                  np.outer(np.sin(thetas), np.sin(phis)).ravel(),
                  np.repeat(np.cos(thetas), m)], -1)
    f = [[i * m + j, i * m + (j + 1) % m, (i + 1) * m + j] for i in range(n_sub - 1)
         for j in range(m)]
    f += [[i * m + (j + 1) % m, (i + 1) * m + (j + 1) % m, (i + 1) * m + j]
          for i in range(n_sub - 1) for j in range(m)]
    top, bot, last = len(v), len(v) + 1, (n_sub - 1) * m
    f += [[top, (j + 1) % m, j] for j in range(m)]
    f += [[bot, last + j, last + (j + 1) % m] for j in range(m)]
    v = np.concatenate([v, [[0, 0, 1], [0, 0, -1]]]) + np.asarray(center)
    return v.astype(np.float32), np.asarray(f, np.int32)


def mesh_phases(dev, kernels):
    """Phases 36-40: the mesh-processing slice (no kernel of its own: its
    only kernels are the union passes that the normals of
    ``ReconstructionModel`` and of ``analyze_data`` run at 65,536 points
    and above). Each entry runs on the card, is checked against the
    JAX package's pick and the port's CPU results
    (``tools/mesh_references.py``) or a CPU run in this script, and is timed with
    its peak, device busy time and host syncs. Returns (launches of the
    counted runs, numbers for the log)."""
    import tempfile

    import threecrate_tpu_torch as tt
    from threecrate_tpu_torch.ops import neighbors
    from threecrate_tpu_torch.reconstruction import pipeline
    from threecrate_tpu_torch.utils.profiling import device_profile
    mls = importlib.import_module("threecrate_tpu_torch.reconstruction.moving_least_squares")
    bpa = importlib.import_module("threecrate_tpu_torch.reconstruction.ball_pivoting")

    total = dict.fromkeys(kernels.WRAPPERS, 0)
    report = {"card": card_line()}
    cpu = torch.device("cpu")
    algo = pipeline.Algorithm

    def timed(fn):
        """(fn(), ms on the host clock around it and a synchronise)."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, 1e3 * (time.perf_counter() - t0)

    def once(fn):
        """A warm host-bound call measured once a way: ms, peak GiB, device
        busy ms (``device_profile`` with no warm-up) and host syncs."""
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        ms = timed(fn)[1]
        peak = torch.cuda.max_memory_allocated() / 2**30
        busy = device_profile(fn, warmup=0)[1]
        return {"ms": ms, "peak_gib": peak, "busy_ms": busy,
                "host_syncs": host_syncs(fn, warmup=False)}

    def fmt(m):
        return (f"{m['ms']:.1f} ms, peak {m['peak_gib']:.3f} GiB, device busy "
                f"{m['busy_ms']:.1f} ms (idle share {1 - m['busy_ms'] / m['ms']:.3f}), "
                f"{m['host_syncs']} host syncs ({report['card']})")

    t_phase = time.perf_counter()

    def phase_seconds():
        nonlocal t_phase
        t, t_phase = time.perf_counter() - t_phase, time.perf_counter()
        return f"{t:.1f} s"

    def no_kernel(fn):
        out, counts = run_counted(kernels, total, fn)
        check(not any(counts.values()), "an entry of the mesh slice launched a kernel")
        return out

    # -- phase 36 -----------------------------------------------------------
    log(f"phase 36: ReconstructionModel(k=10) on {MESH_N:,} points of BASELINE #5's bumpy "
        f"sphere at sigma {MESH_SIGMA} (seed {MESH_SEED})")
    ref = PORT_CPU_MESH["phase36"]
    pts = bumpy_sphere(MESH_N, MESH_SIGMA)
    cloud = tt.PointCloud.from_numpy(pts, device=dev)
    # the unsimplified mesh's faces set the target, as r3_probe halves them
    # (this call also warms every stage up)
    target = max(int(tt.ReconstructionModel(k=10)(cloud).face_count()) // 2, 100)
    model = tt.ReconstructionModel(k=10, target_faces=target)
    mesh, counts = run_counted(kernels, total, lambda: model(cloud))
    n_model = int(mesh.face_count())
    stage = {}
    filt, stage["sor"] = timed(lambda: tt.statistical_outlier_removal(cloud, k=10))
    clean, stage["compact"] = timed(lambda: filt.cloud.compact())
    withn, stage["normals"] = timed(lambda: tt.estimate_normals(clean, k=10))
    ch, stage["analysis"] = timed(lambda: pipeline.analyze_data(withn))
    pick = pipeline.select_algorithm(ch, pipeline.PipelineConfig())
    cfg = tt.MlsConfig(search_radius=max(ch.mean_spacing * 4, 1e-3))
    smoothed, stage["mls"] = timed(lambda: tt.mls_smooth(withn, cfg))
    grid, stage["signed_field"] = timed(lambda: mls._signed_field(smoothed, 48))
    stage["marching_cubes"] = timed(lambda: tt.marching_cubes(grid, 0.0))[1]
    res, stage["auto_reconstruct"] = timed(lambda: pipeline.auto_reconstruct_detailed(withn))
    faces = int(res.mesh.face_count())
    stage["simplification"] = timed(lambda: tt.simplify_mesh(res.mesh, target))[1]
    near = neighbors.knn(cloud.points, cloud.mask, mesh.vertices[mesh.vertex_mask], None,
                         1).distances[:, 0].cpu().numpy() / ch.mean_spacing
    near_share = float((near <= NEAR_SPACINGS).mean())
    m36 = once(lambda: model(cloud))
    k8 = device_profile(lambda: pipeline.analyze_data(withn), top=1000, warmup=0)
    union_k8 = {e[0][:90]: (e[1], e[2]) for e in k8[2] if "union" in e[0].lower()}
    log(f"  JAX's pick on the CPU {JAX_PICKS['phase36']}; the port's CPU run "
        f"{ref['algorithm']} with {ref['faces']} faces ({ref['points']} points kept), "
        f"{ref['simplified_faces']} after simplification")
    log(f"  card: {int(clean.size())} points kept; analysis {json.dumps(ch._asdict())}; pick "
        f"{pick.value}; auto_reconstruct_detailed: {res.algorithm.value}, fallbacks "
        f"{[a.value for a in res.fallbacks_used]}, {faces} faces; target {target}")
    log(f"  stages (ms, one warm call each, after the counted model call): "
        f"{json.dumps(stage)}")
    log(f"  ReconstructionModel(k=10, target_faces={target}): {n_model} faces, launches "
        f"{ {k: n for k, n in counts.items() if n} }; vertices within {NEAR_SPACINGS} mean "
        f"spacings of the input: {near_share:.4f} (CPU run {ref['near_share']:.4f}), distance "
        f"quantiles 50/90/99/100% {np.quantile(near, [0.5, 0.9, 0.99, 1]).round(3).tolist()} "
        f"spacings; {fmt(m36)}")
    log(f"  union kernels in one analyze_data call (k = 8; ms, count): {json.dumps(union_k8)}; "
        f"phase {phase_seconds()}")
    check(pick.value == res.algorithm.value == ref["algorithm"] == JAX_PICKS["phase36"],
          "phase 36 picked another algorithm than the CPU runs")
    check(res.fallbacks_used == [] and ref["fallbacks"] == [], "phase 36 fell back")
    check(abs(faces - ref["faces"]) <= 0.01 * ref["faces"], "phase 36's mesh differs from the CPU's")
    check(n_model <= target and abs(n_model - ref["simplified_faces"])
          <= 0.01 * ref["simplified_faces"], "phase 36's simplified mesh differs from the CPU's")
    check(abs(near_share - ref["near_share"]) <= NEAR_SHARE_TOL,
          "phase 36's mesh lies elsewhere than the CPU run's")
    check(only(counts, {"union_window_a": 2, "union_window_b": 2}),
          "ReconstructionModel did not run the union kernels at k = 10 and k = 8 once each")
    report["ReconstructionModel 100k"] = {**m36, "faces": n_model, "target": target,
                                          "unsimplified_faces": faces, "algorithm": pick.value,
                                          "near_share": near_share,
                                          "stages_ms": stage, "union_k8": union_k8,
                                          "launches": {k: n for k, n in counts.items() if n}}

    log(f"phase 36b: ReconstructionModel's stages up to select_algorithm at sigma "
        f"{BASELINE5_SIGMA} (BASELINE #5's own noise)")
    for n in BASELINE5_SIZES:
        c = tt.PointCloud.from_numpy(bumpy_sphere(n, BASELINE5_SIGMA), device=dev)
        t = {}
        f, t["sor"] = timed(lambda: tt.statistical_outlier_removal(c, k=10))
        cl, t["compact"] = timed(lambda: f.cloud.compact())
        w, t["normals"] = timed(lambda: tt.estimate_normals(cl, k=10))
        chb, t["analysis"] = timed(lambda: pipeline.analyze_data(w))
        p = pipeline.select_algorithm(chb, pipeline.PipelineConfig())
        log(f"  {n:,} points: pick {p.value} (JAX: {JAX_PICKS[n]}); analysis "
            f"{json.dumps(chb._asdict())}; stages ms {json.dumps(t)}")
        check(p.value == JAX_PICKS[n], f"phase 36b picked {p.value} at {n} points")
        report[f"pick sigma {BASELINE5_SIGMA} {n}"] = {"algorithm": p.value, "stages_ms": t}
    log(f"  phase {phase_seconds()}")

    # -- phase 37 -----------------------------------------------------------
    log("phase 37: BASELINE #5 as benchmarks/r3_probe.py runs it: normals (k = 10), "
        "poisson_reconstruct(PoissonConfig(depth=6)), simplify_mesh to half the faces")
    poisson_mesh = None
    for n in BASELINE5_SIZES:
        jref = JAX_POISSON[n]
        pc = tt.estimate_normals(tt.PointCloud.from_numpy(bumpy_sphere(n, BASELINE5_SIGMA),
                                                          device=dev), 10)
        cfg6 = tt.PoissonConfig(depth=6)
        pm = no_kernel(lambda: tt.poisson_reconstruct(pc, cfg6))
        pf = int(pm.face_count())
        tgt = max(pf // 2, 100)
        simp, simp_ms = timed(lambda: tt.simplify_mesh(pm, tgt))
        sf = int(simp.face_count())
        err = bumpy_radius_error(simp.to_numpy()[0])
        med, p99 = float(np.median(err)), float(np.percentile(err, 99))
        m37 = measure(lambda: tt.poisson_reconstruct(pc, cfg6))
        log(f"  {n:,} points: {pf} faces (JAX {jref['faces']}), simplified to {sf} of "
            f"{tgt} in {simp_ms:.0f} ms on the host (JAX {jref['simplified_faces']}); radius "
            f"error median {med:.5f}, p99 {p99:.5f} (gates {jref['median']}, {jref['p99']}); "
            f"poisson_reconstruct {fmt(m37)}")
        check(sf <= tgt and med <= jref["median"] and p99 <= jref["p99"],
              f"phase 37's pipeline at {n} points is off the bumpy sphere or over its target")
        report[f"poisson+QEM {n}"] = {**m37, "faces": pf, "simplified_faces": sf,
                                      "simplify_ms": simp_ms, "radius_median": med,
                                      "radius_p99": p99}
        if poisson_mesh is None:
            poisson_mesh = pm
    log(f"  phase {phase_seconds()}")

    # -- phase 38 -----------------------------------------------------------
    radius = float(np.float32(cfg.search_radius))
    log(f"phase 38: MLS on phase 36's {int(withn.size()):,} clean points, search radius "
        f"{radius:.5f} (4 mean spacings)")
    pts_d, mask_d = withn.points, withn.mask
    t = {}
    search, t["radius_search"] = timed(lambda: neighbors.radius_neighbors(
        pts_d, mask_d, pts_d, mask_d, radius, cfg.max_neighbors))
    reg = float(np.float32(cfg.regularization))

    def fit():
        return mls._mls_project_rows(pts_d[search.indices], search.mask, search.distances,
                                     pts_d, mask_d, radius, cfg.kernel, cfg.basis.value, reg)

    _, t["fits_and_solves"] = timed(fit)
    fit_profile = device_profile(fit, top=1000, warmup=0)
    solve_ms = sum(e[1] for e in fit_profile[2]
                   if any(s in e[0].lower() for s in ("potrf", "potrs", "cholesky", "trsm")))
    log("  the fit's largest device entries (ms, count): " + json.dumps(
        [(e[0][:60], round(e[1], 3), e[2]) for e in fit_profile[2][:6]]))
    sm = no_kernel(lambda: tt.mls_smooth(withn, cfg))
    _, t["signed_field"] = timed(lambda: mls._signed_field(sm, 48))
    rec = no_kernel(lambda: tt.mls_reconstruct(withn, cfg, grid_resolution=48))
    m38 = once(lambda: tt.mls_reconstruct(withn, cfg, grid_resolution=48))
    n_valid = int(withn.size())
    sel = torch.arange(0, n_valid, MLS_CPU_EVERY)
    t0 = time.perf_counter()
    pc_, mc_ = pts_d.cpu(), mask_d.cpu()
    res_c = neighbors.radius_neighbors(pc_, mc_, pc_[sel], mc_[sel], radius, cfg.max_neighbors)
    proj_c, nrm_c, valid_c = mls._mls_project_rows(pc_[res_c.indices], res_c.mask,
                                                   res_c.distances, pc_[sel], mc_[sel], radius,
                                                   cfg.kernel, cfg.basis.value, reg)
    cpu_ms = 1e3 * (time.perf_counter() - t0)
    seld = sel.to(dev)

    def agreement(proj, nrm):
        """Per point (|Δp| / radius, |cos| of the normals) against the CPU fit."""
        return ((proj.cpu() - proj_c).abs().amax(1) / radius,
                (nrm.cpu() * nrm_c).sum(1).abs())

    # the search: neighbour sets, and d² slot by slot where the ids agree
    card_ids = torch.where(search.mask, search.indices, -1)[seld].cpu()
    cpu_ids = torch.where(res_c.mask, res_c.indices, -1)
    rows_same = (torch.sort(card_ids, 1).values == torch.sort(cpu_ids, 1).values).all(1)
    slot_same = (card_ids == cpu_ids) & res_c.mask
    d2_err = (search.distances[seld].cpu() ** 2 - res_c.distances ** 2)[slot_same].abs().max()
    other_sets = 1 - rows_same.float().mean().item()
    # the fit alone: the card's fit of the CPU's own neighbourhoods
    fit_g = mls._mls_project_rows(pts_d[res_c.indices.to(dev)], res_c.mask.to(dev),
                                  res_c.distances.to(dev), pts_d[seld], mask_d[seld], radius,
                                  cfg.kernel, cfg.basis.value, reg)
    dp_fit, cos_fit = agreement(fit_g[0], fit_g[1])
    fit_share = ((dp_fit <= MLS_POS_TOL) & (cos_fit >= MLS_COS_TOL)).float().mean().item()
    # end to end: the card's own search and fit
    dp, cos = agreement(sm.points[seld], sm.normals[seld])
    valid_g = sm.normals[seld].cpu().abs().sum(1) > 0
    shares = {f"{tol:g}": ((dp <= tol) & (cos >= MLS_COS_TOL)).float().mean().item()
              for tol in (1e-5, 1e-4, 1e-3, 1e-2)}
    log(f"  stages ms {json.dumps(t)}; the Cholesky kernels {solve_ms:.2f} ms of the fit's "
        f"device time; mls_reconstruct(grid 48): {int(rec.face_count())} faces (phase 36: "
        f"{faces}); {fmt(m38)}")
    log(f"  against the CPU run on every {MLS_CPU_EVERY}th point ({len(sel)} points, "
        f"{cpu_ms:.0f} ms): the search found another neighbour set on {other_sets:.5f} of them "
        f"(need <= {MLS_OTHER_SETS}), d² within {d2_err:.3e} where the ids agree (tol "
        f"{MLS_D2_TOL}); the card's fit of the CPU's neighbourhoods within {MLS_POS_TOL} of "
        f"the radius with |cos| >= {MLS_COS_TOL} on {fit_share:.5f} (need >= {MLS_SHARE}); end "
        f"to end, shares within each tolerance of the radius {json.dumps(shares)} (need all "
        f"within {MLS_END_TOL}), largest {dp.max().item():.3e}; valid equal "
        f"{torch.equal(valid_g, valid_c)}; phase {phase_seconds()}")
    check(other_sets <= MLS_OTHER_SETS and d2_err <= MLS_D2_TOL and fit_share >= MLS_SHARE
          and dp.max().item() <= MLS_END_TOL and torch.equal(valid_g, valid_c),
          "MLS on the card disagrees with the CPU run")
    check(int(rec.face_count()) == faces, "mls_reconstruct differs from phase 36's MLS mesh")
    report["mls 85k"] = {**m38, "stages_ms": t, "cholesky_ms": solve_ms, "other_sets": other_sets,
                         "d2_err": d2_err.item(), "fit_share": fit_share, "shares": shares,
                         "max_dp": dp.max().item(), "cpu_ms": cpu_ms}
    del search, sm, rec, smoothed, grid

    # -- phase 39 -----------------------------------------------------------
    log("phase 39: alpha shape, ball pivoting and Delaunay through "
        "auto_reconstruct_detailed(PipelineConfig(preferred=...))")
    inputs = {"alpha_shape": fibonacci_sphere(ALPHA_N), "ball_pivoting": fibonacci_sphere(BPA_N),
              "delaunay": terrain(DELAUNAY_N)}
    for name, p in inputs.items():
        c = tt.estimate_normals(tt.PointCloud.from_numpy(p, device=dev), k=10)
        config = pipeline.PipelineConfig(preferred=algo(name))
        r, ms = timed(lambda: no_kernel(lambda: pipeline.auto_reconstruct_detailed(c, config)))
        nf, cref = int(r.mesh.face_count()), PORT_CPU_MESH[name]
        extra = ""
        if name == "ball_pivoting":
            # its only device work is the candidate search: equal lists give
            # the CPU's mesh. On the Fibonacci lattice many neighbours tie,
            # so two lists may order (or cut at the 16th) tied ids apart;
            # slot by slot their d² must agree within BPA_D2_TOL
            ids, ok, d = bpa._candidates(c, bpa.BallPivotingConfig().k_candidates)
            ids_c, ok_c, d_c = bpa._candidates(tt.PointCloud(c.points.cpu(), c.mask.cpu()),
                                               bpa.BallPivotingConfig().k_candidates)
            rows_same = float(((ids == ids_c) | ~ok).all(1)[:len(p)].mean())
            d2_err = float(np.abs(d[ok] ** 2 - d_c[ok] ** 2).max())
            extra = (f"; candidate lists equal to the CPU's on {rows_same:.4f} of the points, "
                     f"d² within {d2_err:.2e} slot by slot (tol {BPA_D2_TOL})")
            check(np.array_equal(ok, ok_c) and d2_err <= BPA_D2_TOL,
                  "BPA's candidates on the card differ from the CPU's")
        busy = device_profile(lambda: pipeline.auto_reconstruct_detailed(c, config),
                              warmup=0)[1] if name != "ball_pivoting" else None
        log(f"  {name}, {len(p):,} points: {r.algorithm.value}, fallbacks "
            f"{[a.value for a in r.fallbacks_used]}, {nf} faces (CPU run {cref['faces']}) in "
            f"{ms:.0f} ms" + (f", device busy {busy:.1f} ms" if busy is not None else "")
            + extra)
        check(r.algorithm.value == name and r.fallbacks_used == []
              and abs(nf - cref["faces"]) <= 0.01 * cref["faces"],
              f"phase 39's {name} differs from the CPU run")
        report[f"{name} {len(p)}"] = {"ms": ms, "busy_ms": busy, "faces": nf}
    log(f"  phase {phase_seconds()}")

    # -- phase 40 -----------------------------------------------------------
    log("phase 40: mesh smoothing on phase 34's welded mesh, clustering and edge collapse on "
        "phase 37's Poisson mesh, booleans, a ProgressiveMesh round trip")
    welded = welded_mesh(tt, dev)
    welded_cpu = tt.TriangleMesh(*(x.cpu() for x in (welded.vertices, welded.faces,
                                                     welded.vertex_mask, welded.face_mask)))
    vm = welded.vertex_mask
    nv, nf = int(vm.sum()), int(welded.face_count())
    for name in ("smooth_laplacian", "smooth_taubin", "smooth_hc"):
        fn = getattr(tt, name)
        a = no_kernel(lambda: fn(welded)).vertices[vm]
        b = fn(welded).vertices[vm]
        t0 = time.perf_counter()
        c = fn(welded_cpu).vertices[vm.cpu()]
        cpu_ms = 1e3 * (time.perf_counter() - t0)
        spread = (a - b).abs().max().item()
        diff = (a.cpu() - c).abs().max().item()
        m = measure(lambda: fn(welded))
        log(f"  {name} on {nv} vertices, {nf} faces: two calls differ by {spread:.2e} m, the "
            f"CPU run ({cpu_ms:.0f} ms) by {diff:.2e} m (tol {SMOOTH_TOL}); {fmt(m)}")
        check(spread <= SMOOTH_TOL and diff <= SMOOTH_TOL,
              f"{name} on the card disagrees with itself or the CPU")
        report[name] = {**m, "spread": spread, "cpu_diff": diff, "cpu_ms": cpu_ms}
    pf = int(poisson_mesh.face_count())
    cl, cl_ms = timed(lambda: no_kernel(lambda: tt.simplification.cluster_simplify(
        poisson_mesh)))
    ec, ec_ms = timed(lambda: no_kernel(lambda: tt.EdgeCollapseSimplifier().simplify(
        poisson_mesh, pf // 2)))
    log(f"  cluster_simplify of the {pf}-face Poisson mesh: {int(cl.face_count())} faces in "
        f"{cl_ms:.0f} ms; EdgeCollapseSimplifier to {pf // 2}: {int(ec.face_count())} faces in "
        f"{ec_ms:.0f} ms (host)")
    check(0 < int(cl.face_count()) < pf and 0 < int(ec.face_count()) <= pf // 2 + 8
          and cl.device.type == ec.device.type == dev.type, "phase 40's simplifiers failed")
    report["cluster_simplify"] = {"ms": cl_ms, "faces": int(cl.face_count())}
    report["edge_collapse"] = {"ms": ec_ms, "faces": int(ec.face_count())}
    sa = tt.TriangleMesh.from_numpy(*uv_sphere(BOOLEAN_RINGS), device=dev)
    sb = tt.TriangleMesh.from_numpy(*uv_sphere(BOOLEAN_RINGS, (0.6, 0.1, 0.05)), device=dev)
    for name in ("mesh_union", "mesh_intersection", "mesh_difference"):
        out, ms = timed(lambda: no_kernel(lambda: getattr(tt, name)(sa, sb)))
        log(f"  {name} of two {int(sa.face_count())}-face spheres: {int(out.face_count())} "
            f"faces in {ms:.0f} ms (host)")
        check(int(out.face_count()) > 0 and out.device.type == dev.type, f"{name} failed")
        report[name] = {"ms": ms, "faces": int(out.face_count())}
    src = tt.TriangleMesh.from_numpy(*uv_sphere(16), device=dev)
    (prog, ms) = timed(lambda: tt.ProgressiveMesh.from_mesh(src, 200))
    BUILD = Path(__file__).resolve().parent / "build"
    BUILD.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD) as tmp:
        prog.save(Path(tmp) / "pm.npz")
        back = tt.ProgressiveMesh.load(Path(tmp) / "pm.npz")
    full = back.full_mesh(device=dev)
    round_trip = all(np.array_equal(a, b) for a, b in zip(full.to_numpy(), src.to_numpy()))
    lods = [int(m.face_count()) for m in back.lod_levels(4, device=dev)]
    log(f"  ProgressiveMesh of a {int(src.face_count())}-face sphere to 200 faces in {ms:.0f} "
        f"ms, {len(prog.splits)} splits; saved and loaded: full mesh equal to the input "
        f"{round_trip}, LOD faces {lods}; phase {phase_seconds()}")
    check(round_trip and lods[0] <= 200 and lods[-1] == int(src.face_count())
          and full.device.type == dev.type, "the ProgressiveMesh round trip failed")
    report["progressive"] = {"ms": ms, "lods": lods}
    return total, report


def io_phases(dev, kernels, phase5_pose, phase5_launches):
    """Phases 41-43: the file-to-segments slice (no kernel of its own; the
    pair read from ``.bin`` runs kernels 1-3 through ``PerceptionStep``).
    The files go to a temporary directory under ``build/``. Each entry
    runs on the card and is checked against the arrays written, a plain
    reading of the file, the port's CPU run or the JAX package's CPU
    result (``tools/io_references.py``). Returns (launches of the
    counted runs, numbers for the log)."""
    import tempfile

    import threecrate_tpu_torch as tt
    from threecrate_tpu_torch import native
    from threecrate_tpu_torch.io import lidar, ply
    from threecrate_tpu_torch.models import PerceptionStep
    from threecrate_tpu_torch.ops import neighbors, segmentation
    from threecrate_tpu_torch.utils.profiling import median_time

    total = dict.fromkeys(kernels.WRAPPERS, 0)
    report = {"card": card_line()}
    cpu = torch.device("cpu")
    t_phase = time.perf_counter()

    def read_median(fn):
        """ms of ``fn()``, median of READ_ITERS after READ_WARMUP calls (CUDA
        events), as bench.py times its read lines."""
        return 1e3 * median_time(fn, warmup=READ_WARMUP, iters=READ_ITERS)

    def phase_seconds():
        nonlocal t_phase
        t, t_phase = time.perf_counter() - t_phase, time.perf_counter()
        return f"{t:.1f} s"

    def no_kernel(fn):
        out, counts = run_counted(kernels, total, fn)
        check(not any(counts.values()), "an entry of the file-to-segments slice launched a kernel")
        return out

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, 1e3 * (time.perf_counter() - t0)

    def fmt(m):
        return (f"{m['ms']:.2f} ms median of 3, peak {m['peak_gib']:.3f} GiB, device busy "
                f"{m['busy_ms']:.2f} ms (idle share {1 - m['busy_ms'] / m['ms']:.3f}), "
                f"{m['host_syncs']} host syncs ({report['card']})")

    check(native.available(), "the native I/O library did not build or load")
    log(f"  native I/O library {native.library_path().name} loaded")
    build = Path(__file__).resolve().parent / "build"
    build.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as tmp_dir:
        tmp = Path(tmp_dir)

        # -- phase 41 -------------------------------------------------------
        log("phase 41: phase 5's pair with a seeded intensity column through .bin, PLY (binary "
            "and ASCII), PCD (binary and binary_compressed) and .xyz, read onto the card")
        src = scan(N_SCAN, 0)
        rng = np.random.default_rng(IO_SEED)
        written = {name: (pts, rng.uniform(0, 255, N_SCAN).astype(np.float32))
                   for name, pts in (("source", src), ("target", src + SHIFT))}
        formats = {"bin": ("bin", {}), "ply": ("ply", {}), "ply_ascii": ("ply", {"binary": False}),
                   "pcd": ("pcd", {}), "pcd_compressed": ("pcd", {"compressed": True}),
                   "xyz": ("xyz", {})}
        files, write_ms = {}, {}
        for name, (pts, inten) in written.items():
            host = tt.PointCloud.from_numpy(pts, intensity=inten, device=cpu)
            for key, (ext, kw) in formats.items():
                files[name, key] = tmp / f"{name}_{key}.{ext}"
                write_ms[f"{name} {key}"] = timed(
                    lambda: tt.write_point_cloud(files[name, key], host, **kw))[1]
        read_report, bin_pair = {}, {}
        for (name, key), path in files.items():
            native.reset_counts()
            cloud, ms = timed(lambda: no_kernel(lambda: tt.read_point_cloud(path)))
            parser = dict(native.counts)
            got = cloud.to_numpy(), cloud.attr_to_numpy("intensity")
            pts, inten = written[name]
            if key in ("ply_ascii", "xyz"):
                # NumPy's parse of the same text, the native parser's plain version
                text = path.read_bytes()
                if key == "ply_ascii":
                    text = text[text.index(b"end_header\n") + len(b"end_header\n"):]
                table = np.array(text.split(), np.float64).reshape(-1, 4).astype(np.float32)
                want = table[:, :3], table[:, 3]
                check(parser.get("native") == 1 and not parser.get("numpy"),
                      f"{name} {key} did not run the native parser: {parser}")
            else:
                want = pts, inten
            equal = all(np.array_equal(a, b) for a, b in zip(got, want))
            rel = float(np.abs(got[0] - pts).max() / np.abs(pts).max())
            log(f"  {name} {key}: {path.stat().st_size / 2**20:.1f} MiB written in "
                f"{write_ms[f'{name} {key}']:.0f} ms, read onto {cloud.device} in {ms:.1f} ms; "
                f"points and intensity bit-equal to the {'text' if key in ('ply_ascii', 'xyz') else 'arrays'} "
                f"written {equal}; largest |read - written| {rel:.2e} of max|p|; parser calls {parser}")
            check(cloud.device.type == "cuda" and equal, f"{name} {key} read back wrong")
            read_report[f"{name} {key}"] = {"read_ms": ms, "write_ms": write_ms[f"{name} {key}"],
                                            "bytes": path.stat().st_size, "max_rel_err": rel}
            if key == "bin":
                bin_pair[name] = cloud
            del cloud

        native.reset_counts()
        path = {k: files["source", k] for k in formats}
        parse = {"read_ply_raw binary": read_median(lambda: ply.read_ply_raw(path["ply"])),
                 "read_ply_raw ascii": read_median(lambda: ply.read_ply_raw(path["ply_ascii"])),
                 "read_kitti_bin_raw": read_median(lambda: lidar.read_kitti_bin_raw(path["bin"]))}
        check(native.counts["native"] == READ_WARMUP + READ_ITERS and not native.counts["numpy"],
              f"the timed ASCII parse did not run the native parser: {dict(native.counts)}")
        table = lidar.read_kitti_bin_raw(path["bin"])
        upload = read_median(lambda: tt.PointCloud.from_numpy(table[:, :3], intensity=table[:, 3],
                                                              device=dev))
        whole = {k: read_median(lambda: tt.read_point_cloud(p)) for k, p in path.items()}
        log(f"  host parse of the 1M source (ms, median of {READ_ITERS} after {READ_WARMUP}; the "
            f"ASCII parse ran the native parser {native.counts['native']} times, NumPy "
            f"{native.counts['numpy']}): {json.dumps(parse)}; upload of the parsed table "
            f"{upload:.2f} ms; whole read_point_cloud onto the card: {json.dumps(whole)} "
            f"({report['card']})")
        report["read"] = {"files": read_report, "parse_ms": parse, "upload_ms": upload,
                          "read_point_cloud_ms": whole}

        step = PerceptionStep()
        s_c, t_c = bin_pair["source"], bin_pair["target"]
        res, counts = run_counted(kernels, total, lambda: step(
            s_c.points[:N_SCAN], s_c.mask[:N_SCAN], t_c.points[:N_SCAN], t_c.mask[:N_SCAN]))
        pose = res.transform.cpu().numpy()
        mask = np.ones(N_SCAN, bool)
        mem = [step(src, mask, src + SHIFT, mask).transform.cpu().numpy() for _ in range(2)]
        spread = max(float(np.abs(a - b).max()) for a, b in
                     ((mem[0], mem[1]), (mem[0], phase5_pose), (mem[1], phase5_pose)))
        diff = float(np.abs(pose - phase5_pose).max())
        kernel_1_3 = ("union_window_a", "union_window_b", "icp_match")
        log(f"  PerceptionStep() on the pair read from .bin: pose within {diff:.3e} of phase 5's "
            f"(two in-memory calls and phase 5 spread {spread:.3e}; tol max({POSE_FILE_TOL}, "
            f"spread)); launches {counts} (phase 5: "
            f"{ {k: phase5_launches[k] for k in kernel_1_3} })")
        check(diff <= max(POSE_FILE_TOL, spread), "the file-fed pose differs from phase 5's")
        check(all(counts[k] == phase5_launches[k] for k in kernel_1_3)
              and only(counts, {k: phase5_launches[k] for k in kernel_1_3}),
              "the file-fed step launched other kernels than phase 5")
        report["perception_from_bin"] = {"pose_diff": diff, "in_memory_spread": spread,
                                         "launches": counts}
        del bin_pair, s_c, t_c, res

        mesh = welded_mesh(tt, dev)
        v, f = mesh.to_numpy()
        obj_v = np.array(" ".join(f"{x:.6g}" for x in v.ravel()).split(),
                         np.float32).reshape(-1, 3)
        mesh_report = {}
        for ext in ("ply", "obj", "stl"):
            mpath = tmp / f"mesh.{ext}"
            tt.write_mesh(mpath, mesh)
            back, ms = timed(lambda: no_kernel(lambda: tt.read_mesh(mpath)))
            rv, rf = back.to_numpy()
            if ext == "stl":
                corners, n_unique = plain_stl_weld(mpath)
                ok = len(rv) == n_unique and np.array_equal(rv[rf], corners)
                what = (f"{len(rv)} welded vertices of {len(v)}, corners equal to a plain weld "
                        f"of the file {ok}, within {np.abs(rv[rf] - v[f]).max():.1e} m of the "
                        f"corners written")
            else:
                ok = np.array_equal(rf, f) and np.array_equal(rv, v if ext == "ply" else obj_v)
                what = (f"faces and vertices equal to the {'arrays' if ext == 'ply' else 'text'}"
                        f" written {ok}")
            log(f"  phase 34's mesh ({len(v)} vertices, {len(f)} faces) through .{ext}: read onto "
                f"{back.device} in {ms:.1f} ms; {what}")
            check(ok and back.device.type == "cuda", f"the mesh read back from .{ext} is wrong")
            mesh_report[ext] = {"read_ms": ms, "vertices": len(rv), "faces": len(rf)}
        report["mesh_files"] = mesh_report
        del mesh
        log(f"  phase {phase_seconds()}")

        # -- phase 42 -------------------------------------------------------
        log(f"phase 42: a street of the 1M scan's ground and {STREET_BOXES} boxes of "
            f"{STREET_BOX} m through binary PCD, then voxel_grid_filter({STREET_VOXEL}), "
            f"segment_plane({STREET_PLANE_TOL}, {STREET_RANSAC}, seed=0), "
            f"extract_plane(negative=True), extract_euclidean_clusters(tolerance="
            f"{STREET_TOLERANCE}, min_cluster_size={STREET_MIN_CLUSTER})")
        pts, source = street_scene()
        spath = tmp / "street.pcd"
        tt.write_point_cloud(spath, tt.PointCloud.from_numpy(pts, device=cpu))
        cloud = no_kernel(lambda: tt.read_point_cloud(spath))
        check(np.array_equal(cloud.to_numpy(), pts), "the street read back wrong")
        det = no_kernel(lambda: tt.voxel_grid_filter_detailed(cloud, STREET_VOXEL))
        vox = no_kernel(lambda: tt.voxel_grid_filter(cloud, STREET_VOXEL))
        check(torch.equal(vox.points, det.cloud.points) and torch.equal(vox.mask, det.cloud.mask),
              "voxel_grid_filter and its detailed form disagree")
        n_vox = int(det.num_voxels)
        down = det.cloud.compact()
        plane = no_kernel(lambda: tt.segment_plane(down, STREET_PLANE_TOL, STREET_RANSAC, seed=0))
        rest = no_kernel(lambda: tt.extract_plane(down, plane, negative=True).compact())
        cfg = tt.EuclideanClusterConfig(tolerance=STREET_TOLERANCE,
                                        min_cluster_size=STREET_MIN_CLUSTER)
        segmentation.reset_counts()
        clusters = no_kernel(lambda: tt.extract_euclidean_clusters(rest, cfg))
        props = dict(segmentation.counts)

        nrm = plane.model.normal.cpu().numpy().astype(np.float64)
        d0 = float(plane.model.d)
        down_np = down.to_numpy()
        height = (down_np @ nrm + d0) * np.sign(nrm[2])
        inl = plane.inlier_mask[:n_vox].cpu().numpy()
        rest_idx = np.flatnonzero(~inl)
        n_rest = len(rest_idx)
        inv = det.voxel_index[:len(pts)].cpu().numpy().astype(np.int64)
        votes = np.bincount(inv * (STREET_BOXES + 1) + source + 1,
                            minlength=n_vox * (STREET_BOXES + 1)).reshape(n_vox, -1)
        vox_box = votes.argmax(1) - 1
        labels = clusters.labels[:n_rest].cpu().numpy()
        n_cl = int(clusters.n_clusters)
        purity, coverage, boxes = [], [], []
        for c in range(n_cl):
            members = rest_idx[labels == c]
            owner = np.bincount(vox_box[members] + 1, minlength=STREET_BOXES + 1)[1:].argmax()
            above = np.flatnonzero((vox_box == owner) & (height > STREET_PLANE_TOL))
            purity.append(float((vox_box[members] == owner).mean()))
            coverage.append(float(np.isin(above, members).mean()))
            boxes.append(int(owner))
        log(f"  {len(pts):,} points, {n_vox:,} voxels; plane normal {nrm.round(6).tolist()}, d "
            f"{d0:.5f}, {int(plane.inlier_count):,} inliers; {n_rest:,} voxels off the plane; "
            f"{n_cl} clusters (need {STREET_BOXES}) from {len(set(boxes))} boxes, purity min "
            f"{min(purity, default=0):.4f}, coverage of the box above the band min "
            f"{min(coverage, default=0):.4f} (need {STREET_PURITY}); label propagation "
            f"{props.get('iterations', 0)} iterations, {props.get('syncs', 0)} host syncs")
        check(abs(nrm[2]) >= 0.999, "the street's plane is not level")
        check(n_cl == STREET_BOXES and len(set(boxes)) == STREET_BOXES
              and min(purity) >= STREET_PURITY and min(coverage) >= STREET_PURITY,
              "the clusters are not the boxes")

        # the port's CPU run: the plane on the same voxels, the radius
        # search on sampled voxels, and the propagation and ranking of the
        # card's neighbour lists
        down_cpu = tt.PointCloud(down.points.cpu(), down.mask.cpu(), {})
        plane_cpu, plane_cpu_ms = timed(lambda: tt.segment_plane(
            down_cpu, STREET_PLANE_TOL, STREET_RANSAC, seed=0))
        n_diff = float(np.abs(plane_cpu.model.normal.numpy() - nrm).max())
        d_diff = abs(float(plane_cpu.model.d) - d0)
        c_card, c_cpu = int(plane.inlier_count), int(plane_cpu.inlier_count)
        flips = int((plane_cpu.inlier_mask != plane.inlier_mask.cpu()).sum())
        log(f"  the CPU run's plane ({plane_cpu_ms:.0f} ms): normal within {n_diff:.2e} (tol "
            f"{STREET_NORMAL_TOL}), d within {d_diff:.2e} m (tol {STREET_D_TOL}), inliers "
            f"{c_cpu:,} against {c_card:,} (tol {STREET_COUNT_TOL:.0e} relative), "
            f"{flips} voxels on the other side")
        check(n_diff <= STREET_NORMAL_TOL and d_diff <= STREET_D_TOL
              and abs(c_cpu - c_card) <= STREET_COUNT_TOL * c_cpu,
              "the plane differs from the CPU run's")
        nbr = neighbors.radius_neighbors(rest.points, rest.mask, rest.points, rest.mask,
                                         cfg.tolerance, cfg.max_neighbors)
        rows = np.sort(np.random.default_rng(IO_SEED).choice(n_rest, STREET_SAMPLE,
                                                             replace=False))
        rp, rm = rest.points.cpu(), rest.mask.cpu()
        cpu_nbr, search_ms = timed(lambda: neighbors.radius_neighbors(
            rp, rm, rp[rows], rm[rows], cfg.tolerance, cfg.max_neighbors))
        card_rows = [x[torch.from_numpy(rows).to(dev)].cpu().numpy() for x in nbr]
        same, worst, unexplained = search_agreement(
            card_rows, [x.numpy() for x in cpu_nbr], rp[rows].numpy(), rp.numpy(),
            cfg.tolerance)
        norm2 = float((rp[:n_rest].double() ** 2).sum(1).max())
        d2_tol = STREET_D2_ULPS * float(np.spacing(np.float32(2 * norm2)))
        host = neighbors.KnnResult(*(x.cpu() for x in nbr))
        lab_cpu, n_cpu, sizes_cpu = segmentation._rank_clusters(
            segmentation._propagate(host, rm), rm, cfg.min_cluster_size, cfg.max_cluster_size)
        labels_equal = (torch.equal(lab_cpu, clusters.labels.cpu()) and int(n_cpu) == n_cl
                        and torch.equal(sizes_cpu, clusters.sizes.cpu()))
        log(f"  the CPU's radius search of {STREET_SAMPLE} sampled voxels ({search_ms:.0f} ms): "
            f"equal neighbour sets on {same:.4f}, the others differ only within the rounding "
            f"band of the radius or the last slot ({unexplained} ids outside it), d² of shared "
            f"ids within {worst:.2e} (tol {d2_tol:.2e}); the CPU's propagation and ranking of "
            f"the card's lists give the card's labels, count and sizes {labels_equal}")
        check(unexplained == 0 and worst <= d2_tol,
              "the radius search differs from the CPU's beyond its rounding")
        check(labels_equal, "the clusters differ from the CPU's propagation of the same lists")
        del nbr, host, cpu_nbr

        stages = {"read_pcd": lambda: tt.read_point_cloud(spath),
                  "voxel_grid_filter": lambda: tt.voxel_grid_filter(cloud, STREET_VOXEL),
                  "segment_plane": lambda: tt.segment_plane(down, STREET_PLANE_TOL,
                                                            STREET_RANSAC, seed=0),
                  "extract_plane_compact": lambda: tt.extract_plane(down, plane,
                                                                    negative=True).compact(),
                  "extract_euclidean_clusters": lambda: tt.extract_euclidean_clusters(rest, cfg)}
        timing = {}
        for name, fn in stages.items():
            timing[name] = measure(fn)
            log(f"  {name}: {fmt(timing[name])}")
        report["street"] = {"points": len(pts), "voxels": n_vox, "inliers": c_card,
                            "off_plane": n_rest, "clusters": n_cl, "purity_min": min(purity),
                            "coverage_min": min(coverage), "propagation": props,
                            "cpu_plane_ms": plane_cpu_ms, "cpu_count": c_cpu, "flips": flips,
                            "search_same_share": same, "stages": timing}
        del cloud, det, vox, down, rest, clusters
        log(f"  phase {phase_seconds()}")

    # -- phase 43 -----------------------------------------------------------
    log(f"phase 43: knn_grid(k={GRID_K}) on the 1M scan with estimate_cell_size")
    pts = scan(N_SCAN, 0)
    cloud = tt.PointCloud.from_numpy(pts, device=dev)
    cell = neighbors.estimate_cell_size(cloud.points, cloud.mask, GRID_K)
    res = no_kernel(lambda: tt.knn_grid(cloud.points, cloud.mask, cloud.points, cloud.mask,
                                        GRID_K, cell))
    sample = grid_sample()
    s_dev = torch.from_numpy(sample).to(dev)
    exact = exact_nearest(cloud.points[:N_SCAN], cloud.points[s_dev], GRID_K)
    recall = grid_recall(res.indices[s_dev], res.mask[s_dev], exact)
    cp, cm = cloud.points.cpu(), cloud.mask.cpu()
    cpu_res, cpu_ms = timed(lambda: neighbors.knn_grid(cp, cm, cp[sample], cm[sample], GRID_K,
                                                       cell))
    ids, dist, valid = (x[s_dev].cpu() for x in res)
    # d² is bit-equal on both (the same rounded steps); the card's sqrt may
    # round the last bit differently, so distances are held to one ulp
    ulp = torch.from_numpy(np.spacing(cpu_res.distances.numpy()))
    d_equal = torch.equal(valid, cpu_res.mask) and bool(
        ((dist - cpu_res.distances).abs() <= ulp)[valid].all())
    dd = torch.where(valid, dist, torch.inf)
    gap = torch.minimum(torch.diff(dd, dim=1, prepend=torch.full((len(sample), 1), -torch.inf)),
                        torch.diff(dd, dim=1, append=torch.full((len(sample), 1), torch.inf)))
    apart = valid & (gap > 0)
    ids_equal = torch.equal(ids[apart], cpu_res.indices[apart])
    m43 = measure(lambda: tt.knn_grid(cloud.points, cloud.mask, cloud.points, cloud.mask,
                                      GRID_K, cell))
    log(f"  cell {cell:.5f} m; recall of the exact {GRID_K} nearest on {GRID_SAMPLE} sampled "
        f"queries {recall:.5f} (the JAX package on the CPU: {JAX_GRID_RECALL}); against the "
        f"port's CPU run on those queries ({cpu_ms:.0f} ms): validity equal and distances "
        f"within an ulp {d_equal}, ids equal where the distances are apart {ids_equal} "
        f"({float(apart.float().mean()):.4f} of slots); {fmt(m43)}")
    check(recall >= JAX_GRID_RECALL, "knn_grid's recall is below the JAX package's")
    check(d_equal and ids_equal, "knn_grid on the card differs from the CPU run")
    report["knn_grid"] = {"cell": cell, "recall": recall, "jax_recall": JAX_GRID_RECALL,
                          "cpu_ms": cpu_ms, **m43}
    log(f"  phase {phase_seconds()}")
    return total, report



def survey_tile():
    """Phase 44's aerial tile: TILE_SIDE m square at TILE_DENSITY points
    a m² from TILE_SEED, flown in strips TILE_STRIP m wide along x (each
    strip's points in flight order, GPS time rising at TILE_RATE points a
    second): rolling terrain, gabled roofs on a 100 m grid and tree
    crowns on a 20 m grid. Returns the points (n, 3) float32 and their
    intensity, RGB in [0, 1] and GPS time."""
    rng = np.random.default_rng(TILE_SEED)
    strips = int(TILE_SIDE / TILE_STRIP)
    per = int(TILE_SIDE * TILE_SIDE * TILE_DENSITY) // strips
    x = np.concatenate([np.sort(rng.uniform(0, TILE_SIDE, per)) for _ in range(strips)])
    y = (np.repeat(np.arange(strips), per) + rng.uniform(0, 1, strips * per)) * TILE_STRIP
    n = len(x)

    def ground_at(gx, gy):
        return (40.0 + 8.0 * np.sin(gx / 130.0) * np.cos(gy / 170.0)
                + 2.5 * np.sin(gx / 37.0 + gy / 53.0))

    ground = ground_at(x, y)
    z = ground + rng.normal(0, 0.03, n)
    kind = np.zeros(n, np.int8)                              # 0 ground, 1 roof, 2 tree
    # buildings: one in 60% of the 100 m cells, 10-40 m a side, 4-20 m tall
    cells = int(TILE_SIDE / 100)
    has = rng.uniform(size=(cells, cells)) < 0.6
    size = rng.uniform(10, 40, (cells, cells, 2))
    corner = rng.uniform(5, 95 - size, (cells, cells, 2)) + 100 * np.stack(
        np.meshgrid(np.arange(cells), np.arange(cells), indexing="ij"), -1)
    height = rng.uniform(4, 20, (cells, cells))
    ci, cj = (x // 100).astype(int), (y // 100).astype(int)
    lo, hi = corner[ci, cj], corner[ci, cj] + size[ci, cj]
    roof = has[ci, cj] & (x >= lo[:, 0]) & (x < hi[:, 0]) & (y >= lo[:, 1]) & (y < hi[:, 1])
    base = ground_at(corner[..., 0] + size[..., 0] / 2, corner[..., 1] + size[..., 1] / 2)
    ridge = np.abs(y - (lo[:, 1] + hi[:, 1]) / 2) * 0.4
    z = np.where(roof, base[ci, cj] + height[ci, cj] - ridge + rng.normal(0, 0.02, n), z)
    kind[roof] = 1
    # trees: one in half of the 20 m cells, crowns of 2-6 m radius, 5-20 m
    # tall; 70% of the returns inside a crown come from its canopy
    cells = int(TILE_SIDE / 20)
    tree = rng.uniform(size=(cells, cells)) < 0.5
    centre = rng.uniform(4, 16, (cells, cells, 2)) + 20 * np.stack(
        np.meshgrid(np.arange(cells), np.arange(cells), indexing="ij"), -1)
    radius = rng.uniform(2, 6, (cells, cells))
    top = rng.uniform(5, 20, (cells, cells))
    ti, tj = (x // 20).astype(int), (y // 20).astype(int)
    d2 = (x - centre[ti, tj, 0]) ** 2 + (y - centre[ti, tj, 1]) ** 2
    r = radius[ti, tj]
    canopy = tree[ti, tj] & ~roof & (d2 < r * r) & (rng.uniform(size=n) < 0.7)
    crown = top[ti, tj] * (1.0 - 0.5 * d2 / (r * r)) - rng.uniform(0, 3, n)
    z = np.where(canopy, ground + np.maximum(crown, 0.5), z)
    kind[canopy] = 2
    base_rgb = np.array([[0.45, 0.40, 0.32], [0.60, 0.30, 0.25], [0.20, 0.45, 0.18]])
    rgb = np.clip(base_rgb[kind] + rng.normal(0, 0.05, (n, 3)), 0, 1).astype(np.float32)
    base_i = np.array([0.30, 0.55, 0.15])
    inten = np.clip(base_i[kind] + rng.normal(0, 0.05, n), 0, 1).astype(np.float32)
    gps = TILE_GPS_START + np.arange(n) / TILE_RATE
    return np.stack([x, y, z], -1).astype(np.float32), inten, rgb, gps


def plain_las_decode(path):
    """A plain NumPy decode of a LAS file's point records (formats 3 and
    6): int·scale + offset to float32, 16-bit intensity and RGB over
    65535, the float64 GPS time to float32 (the cloud's attribute type)."""
    data = path.read_bytes()
    fmt, off = data[104], struct.unpack_from("<I", data, 96)[0]
    n = struct.unpack_from("<Q", data, 247)[0] if data[25] >= 4 else \
        struct.unpack_from("<I", data, 107)[0]
    sx, sy, sz, ox, oy, oz = struct.unpack_from("<6d", data, 131)
    fields = {3: [("xyz", "<i4", 3), ("i", "<u2"), ("pad", "V6"), ("t", "<f8"),
                  ("rgb", "<u2", 3)],
              6: [("xyz", "<i4", 3), ("i", "<u2"), ("pad", "V8"), ("t", "<f8")]}[fmt]
    rec = np.frombuffer(data, np.dtype([f if len(f) == 2 else (f[0], f[1], (f[2],))
                                        for f in fields]), n, off)
    q = rec["xyz"]
    out = {"points": np.stack([q[:, 0] * sx + ox, q[:, 1] * sy + oy, q[:, 2] * sz + oz],
                              -1).astype(np.float32),
           "intensity": rec["i"].astype(np.float32) / 65535.0,
           "gps_time": rec["t"].astype(np.float32)}
    if fmt == 3:
        out["colors"] = rec["rgb"].astype(np.float32) / 65535.0
    return out


def ouster_frames():
    """OUSTER_FRAMES frames of an OS1-128 (128 beams over ±22.5°, 1024
    columns) in a street 24 m wide with walls 12 m tall and the ground
    1.8 m below the sensor, which moves 1 m a frame along x; ranges with
    2 cm noise. Each frame's points in column order (16 columns a
    2,048-point packet)."""
    rng = np.random.default_rng(OUSTER_SEED)
    el = np.deg2rad(np.linspace(-22.5, 22.5, 128))
    az = np.linspace(0, 2 * np.pi, 1024, endpoint=False)
    d = np.stack([np.cos(el)[None] * np.cos(az)[:, None], np.cos(el)[None] * np.sin(az)[:, None],
                  np.broadcast_to(np.sin(el)[None], (1024, 128))], -1).reshape(-1, 3)
    with np.errstate(divide="ignore", invalid="ignore"):
        t_ground = np.where(d[:, 2] < 0, -1.8 / d[:, 2], np.inf)
        t_wall = np.where(np.abs(d[:, 1]) > 1e-9, 12.0 / np.abs(d[:, 1]), np.inf)
        t_top = np.where(d[:, 2] > 0, 10.2 / d[:, 2], np.inf)
    t = np.minimum(np.minimum(t_ground, t_wall), np.minimum(t_top, 120.0))
    frames = []
    for f in range(OUSTER_FRAMES):
        r = t + rng.normal(0, 0.02, len(t))
        frames.append((d * r[:, None] + [f * 1.0, 0.0, 0.0]).astype(np.float32))
    return frames


def street_cameras():
    """Phase 46's six views: cameras 2 m above the street's origin, one
    every 60° of heading, pitched 10° down, at COLOR_INTR."""
    out = []
    for i in range(COLOR_VIEWS):
        yaw, pitch = np.deg2rad(60.0 * i + 15.0), np.deg2rad(10.0)
        fwd = np.array([np.cos(yaw) * np.cos(pitch), np.sin(yaw) * np.cos(pitch),
                        -np.sin(pitch)])
        right = np.array([np.sin(yaw), -np.cos(yaw), 0.0])
        down = np.cross(fwd, right)
        rot = np.stack([right, down, fwd])
        w2c = np.eye(4)
        w2c[:3, :3] = rot
        w2c[:3, 3] = -rot @ np.array([0.0, 0.0, 2.0])
        out.append(w2c.astype(np.float32))
    return out


def cdr_string(s: str) -> bytes:
    b = s.encode() + b"\x00"
    return struct.pack("<I", len(b)) + b


def cdr_pad(buf: bytearray, align: int) -> None:
    rem = (len(buf) - 4) % align
    if rem:
        buf.extend(b"\x00" * (align - rem))


def pointcloud2_cdr(pts, inten, rgb_u8, stamp: int, frame: str = "os_lidar") -> bytes:
    """A CDR-encoded sensor_msgs/PointCloud2 with x, y, z, intensity and
    packed rgb float32 fields, built by hand as tests/test_io_extra.py's
    ``make_pointcloud2_cdr`` builds its xyz messages."""
    n = len(pts)
    rec = np.zeros(n, np.dtype([("x", "<f4"), ("y", "<f4"), ("z", "<f4"),
                                ("intensity", "<f4"), ("rgb", "<u4")]))
    rec["x"], rec["y"], rec["z"] = pts[:, 0], pts[:, 1], pts[:, 2]
    rec["intensity"] = inten
    c = rgb_u8.astype(np.uint32)
    rec["rgb"] = (c[:, 0] << 16) | (c[:, 1] << 8) | c[:, 2]
    buf = bytearray(b"\x00\x01\x00\x00")                 # CDR_LE encapsulation
    buf += struct.pack("<iI", stamp, 0)
    buf += cdr_string(frame)
    cdr_pad(buf, 4)
    buf += struct.pack("<II", 1, n)
    buf += struct.pack("<I", 5)
    for off, name in zip((0, 4, 8, 12, 16), ("x", "y", "z", "intensity", "rgb")):
        buf += cdr_string(name)
        cdr_pad(buf, 4)
        buf += struct.pack("<I", off)
        buf += struct.pack("<B", 7)                     # FLOAT32 (rgb: packed bits)
        cdr_pad(buf, 4)
        buf += struct.pack("<I", 1)
    buf += struct.pack("<B", 0)
    cdr_pad(buf, 4)
    buf += struct.pack("<II", 20, 20 * n)
    data = rec.tobytes()
    buf += struct.pack("<I", len(data)) + data
    buf += struct.pack("<B", 1)
    return bytes(buf)


def write_bag(path, messages, other):
    """A rosbag2 .db3 (sqlite) with the PointCloud2 messages on BAG_TOPIC
    and ``other`` blobs on an Imu topic that readers must skip."""
    conn = sqlite3.connect(str(path))
    conn.executescript("""
        CREATE TABLE topics(id INTEGER PRIMARY KEY, name TEXT, type TEXT,
            serialization_format TEXT, offered_qos_profiles TEXT);
        CREATE TABLE messages(id INTEGER PRIMARY KEY, topic_id INTEGER,
            timestamp INTEGER, data BLOB);""")
    conn.execute("INSERT INTO topics VALUES (1, ?, 'sensor_msgs/msg/PointCloud2', 'cdr', '')",
                 (BAG_TOPIC,))
    conn.execute("INSERT INTO topics VALUES (2, '/imu', 'sensor_msgs/msg/Imu', 'cdr', '')")
    for i, blob in enumerate(messages):
        conn.execute("INSERT INTO messages(topic_id, timestamp, data) VALUES (1, ?, ?)",
                     (1000 + i, blob))
    for i, blob in enumerate(other):
        conn.execute("INSERT INTO messages(topic_id, timestamp, data) VALUES (2, ?, ?)",
                     (1000 + i, blob))
    conn.commit()
    conn.close()


def write_mcap(path, messages, other):
    """An uncompressed MCAP with the same two channels, the messages
    interleaved, records built as tests/test_io_extra.py's ``_make_mcap``
    builds them."""
    def record(op, body):
        return bytes([op]) + struct.pack("<Q", len(body)) + body

    def s(x):
        b = x.encode()
        return struct.pack("<I", len(b)) + b

    buf = bytearray(b"\x89MCAP0\r\n")
    buf += record(0x03, struct.pack("<H", 1) + s("sensor_msgs/msg/PointCloud2") + s("ros2msg")
                  + struct.pack("<I", 0))
    buf += record(0x03, struct.pack("<H", 2) + s("sensor_msgs/msg/Imu") + s("ros2msg")
                  + struct.pack("<I", 0))
    buf += record(0x04, struct.pack("<HH", 7, 1) + s(BAG_TOPIC) + s("cdr") + struct.pack("<I", 0))
    buf += record(0x04, struct.pack("<HH", 8, 2) + s("/imu") + s("cdr") + struct.pack("<I", 0))
    for i, blob in enumerate(messages):
        buf += record(0x05, struct.pack("<HIQQ", 7, i, 1000 + i, 1000 + i) + blob)
        if i < len(other):
            buf += record(0x05, struct.pack("<HIQQ", 8, i, 1000 + i, 1000 + i) + other[i])
    buf += b"\x89MCAP0\r\n"
    Path(path).write_bytes(bytes(buf))


class DictVoxelFilter:
    """The JAX package's ``StreamingVoxelFilter`` accumulator, copied as
    plain NumPy: a host dict from the voxel triple to (sum, count), one
    Python step a voxel of each chunk. Timed beside the port's."""

    def __init__(self, voxel_size: float):
        self.voxel = float(voxel_size)
        self._sums: dict = {}

    def process_chunk(self, chunk: np.ndarray) -> None:
        keys = np.floor(chunk / self.voxel).astype(np.int64)
        uniq, inv = np.unique(keys, axis=0, return_inverse=True)
        sums = np.zeros((len(uniq), 3))
        cnts = np.zeros(len(uniq))
        np.add.at(sums, inv.ravel(), chunk.astype(np.float64))
        np.add.at(cnts, inv.ravel(), 1)
        for k, s, c in zip(map(tuple, uniq), sums, cnts):
            if k in self._sums:
                s0, c0 = self._sums[k]
                self._sums[k] = (s0 + s, c0 + c)
            else:
                self._sums[k] = (s, c)


def ulps_apart(a: np.ndarray, b: np.ndarray) -> int:
    """The largest distance in float32 ulps between two equal-shaped
    float32 arrays (0 where bit-equal)."""
    ia, ib = (np.ascontiguousarray(x, np.float32).view(np.int32).astype(np.int64) for x in (a, b))
    ia = np.where(ia < 0, np.int64(-2**31) - ia, ia)
    ib = np.where(ib < 0, np.int64(-2**31) - ib, ib)
    return int(np.abs(ia - ib).max(initial=0))


def survey_phases(dev, kernels):
    """Phases 44-47: the survey-tile slice (no kernel of its own; kernels
    1-2 through the per-chunk normals of phase 45) through its public
    entries: LAS/LAZ, out-of-core streaming, colorization and the other
    formats, each gated against a plain NumPy decode or the port's own
    CPU run. Returns (launches, numbers for the log)."""
    import tempfile

    import threecrate_tpu_torch as tt
    from threecrate_tpu_torch import native
    from threecrate_tpu_torch.io import artifacts, e57, las, rosbag
    from threecrate_tpu_torch.ops import colorization
    from threecrate_tpu_torch.parallel import streaming
    from threecrate_tpu_torch.utils.profiling import device_profile

    total = dict.fromkeys(kernels.WRAPPERS, 0)
    report = {"card": card_line()}
    cpu = torch.device("cpu")
    t_phase = time.perf_counter()

    def phase_seconds():
        nonlocal t_phase
        t, t_phase = time.perf_counter() - t_phase, time.perf_counter()
        return f"{t:.1f} s"

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, 1e3 * (time.perf_counter() - t0)

    def no_kernel(fn):
        out, counts = run_counted(kernels, total, fn)
        check(not any(counts.values()), "an entry of the survey-tile slice launched a kernel")
        return out

    def host(cloud):
        return {"points": cloud.to_numpy(), **{k: cloud.attr_to_numpy(k) for k in cloud.attrs}}

    def same(a, b):
        return sorted(a) == sorted(b) and all(np.array_equal(a[k], b[k]) for k in a)

    def clock():
        return f"({report['card']}, SM clock {sm_clock()})"

    check(native.laz_available(), "the LASzip library did not build or load")
    log(f"  LASzip library {native.laz_library_path().name} loaded")
    build = Path(__file__).resolve().parent / "build"
    build.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as tmp_dir:
        tmp = Path(tmp_dir)

        # -- phase 44 -------------------------------------------------------
        log(f"phase 44: a {TILE_SIDE:.0f} m tile at {TILE_DENSITY} points/m² (terrain, roofs, "
            f"trees; format 3 at scale {TILE_SCALE}) through .las and chunked .laz onto the card")
        pts, inten, rgb, gps = survey_tile()
        n_tile = len(pts)
        tile = tt.PointCloud.from_numpy(pts, intensity=inten, colors=rgb, gps_time=gps,
                                        device=cpu)
        paths = {"las": tmp / "tile.las", "laz": tmp / "tile.laz"}
        write_ms = {k: timed(lambda: tt.write_point_cloud(p, tile, scale=TILE_SCALE))[1]
                    for k, p in paths.items()}
        plain = plain_las_decode(paths["las"])
        reads, read_ms = {}, {}
        for k, p in paths.items():
            cloud, read_ms[k] = timed(lambda: no_kernel(lambda: tt.read_point_cloud(p)))
            check(cloud.device.type == "cuda", f"the .{k} tile did not land on the card")
            reads[k] = host(cloud)
            del cloud
        las_laz = same(reads["las"], reads["laz"])
        vs_plain = same(reads["las"], plain)
        quant = float(np.abs(plain["points"].astype(np.float64) - pts).max())
        data = paths["laz"].read_bytes()
        off = struct.unpack_from("<I", data, 96)[0]
        _, decompress_ms = timed(lambda: native.laz_decompress(data, off, n_tile, las._DEFAULT_CHUNK,
                                                               3, 34))
        parse_ms = {k: timed(lambda: tt.read_point_cloud(p, device=cpu))[1]
                    for k, p in paths.items()}
        _, upload_ms = timed(lambda: tt.PointCloud.from_numpy(
            plain["points"], intensity=plain["intensity"], colors=plain["colors"],
            gps_time=plain["gps_time"], device=dev))
        sizes = {k: p.stat().st_size for k, p in paths.items()}
        log(f"  {n_tile:,} points; .las {sizes['las'] / 2**20:.1f} MiB written in "
            f"{write_ms['las']:.0f} ms, .laz {sizes['laz'] / 2**20:.1f} MiB "
            f"({sizes['laz'] / sizes['las']:.3f} of it) in {write_ms['laz']:.0f} ms; read onto "
            f"the card: .las {read_ms['las']:.0f} ms, .laz {read_ms['laz']:.0f} ms; host parse "
            f".las {parse_ms['las']:.0f} ms, .laz {parse_ms['laz']:.0f} ms (LASzip decompress "
            f"alone {decompress_ms:.0f} ms); upload of the parsed arrays {upload_ms:.1f} ms "
            f"{clock()}")
        log(f"  points, intensity, RGB and GPS time bit-equal between .las and .laz {las_laz}, "
            f"and to a plain NumPy int·scale + offset decode of the LAS records {vs_plain}; "
            f"largest |decoded - generated| {quant:.2e} m (half the scale: {TILE_SCALE / 2})")
        check(las_laz and vs_plain, "the tile read back from .las/.laz differs")
        check(quant <= TILE_SCALE / 2 + 1e-4, "the tile's decode is off the scale's lattice")
        del reads
        p14 = tmp / "tile14.las"
        sub = tt.PointCloud.from_numpy(pts[:LAS14_POINTS], intensity=inten[:LAS14_POINTS],
                                       gps_time=gps[:LAS14_POINTS], device=cpu)
        _, w14 = timed(lambda: tt.write_point_cloud(p14, sub, point_format=6))
        c14, r14 = timed(lambda: no_kernel(lambda: tt.read_point_cloud(p14)))
        ok14 = same(host(c14), plain_las_decode(p14)) and \
            np.abs(c14.to_numpy().astype(np.float64) - pts[:LAS14_POINTS]).max() <= 1e-3
        log(f"  LAS 1.4 format 6, {LAS14_POINTS:,} points: written in {w14:.0f} ms, read onto "
            f"{c14.device} in {r14:.0f} ms; bit-equal to the plain decode and within the scale "
            f"{ok14}")
        check(ok14 and c14.device.type == "cuda", "the LAS 1.4 round trip is wrong")
        report["tile"] = {"points": n_tile, "bytes": sizes, "write_ms": write_ms,
                          "read_ms": read_ms, "host_parse_ms": parse_ms,
                          "laz_decompress_ms": decompress_ms, "upload_ms": upload_ms,
                          "las14": {"write_ms": w14, "read_ms": r14}}
        del c14, sub, tile, plain
        log(f"  phase {phase_seconds()}")

        # -- phase 45 -------------------------------------------------------
        log(f"phase 45: the tile as binary PLY through read_point_cloud_iter(chunk_size="
            f"{STREAM_CHUNK}) into run_pipeline: StreamingVoxelFilter({STREAM_VOXEL}), "
            f"StreamingStatistics, StreamingDeviceMap(estimate_normals(k={STREAM_K}))")
        ply = tmp / "tile.ply"
        tt.write_point_cloud(ply, tt.PointCloud.from_numpy(pts, device=cpu))
        n_chunks = -(-n_tile // STREAM_CHUNK)
        keep = {0: None, n_chunks // 2: None, n_chunks - 1: None}

        def normals_of(p, m):
            return tt.estimate_normals(tt.PointCloud(p, m, {}), k=STREAM_K).normals

        class Tee:
            """Every chunk to each stage in turn, each stage timed to the
            card's end of it; the first, middle and last chunks kept."""

            def __init__(self, stages):
                self.stages, self.seconds, self.i = stages, dict.fromkeys(stages, 0.0), 0

            def process_chunk(self, chunk):
                if self.i in keep:
                    keep[self.i] = chunk
                self.i += 1
                for name, stage in self.stages.items():
                    t0 = time.perf_counter()
                    stage.process_chunk(chunk)
                    if name != "statistics":
                        torch.cuda.synchronize()
                    self.seconds[name] += time.perf_counter() - t0

            def finalize(self):
                return {name: stage.finalize() for name, stage in self.stages.items()}

            def memory_bytes(self):
                return sum(stage.memory_bytes() for stage in self.stages.values())

        def stages(device, normals=True):
            st = {"voxel": streaming.StreamingVoxelFilter(STREAM_VOXEL, device=device),
                  "statistics": streaming.StreamingStatistics()}
            if normals:
                st["normals"] = streaming.StreamingDeviceMap(normals_of, STREAM_CHUNK, device)
            return st

        tee = Tee(stages(dev))
        t0 = time.perf_counter()
        (res, stats), counts = run_counted(kernels, total, lambda: tt.run_pipeline(
            tt.read_point_cloud_iter(ply, chunk_size=STREAM_CHUNK), tee))
        wall = time.perf_counter() - t0
        parse_s = timed(lambda: sum(len(c) for c in tt.read_point_cloud_iter(
            ply, chunk_size=STREAM_CHUNK)))[1] / 1e3
        voxels = res["voxel"]
        n_vox = len(voxels)
        state_bytes = tee.stages["voxel"].memory_bytes()
        device_state = sum(t.numel() * t.element_size() for t in (
            tee.stages["voxel"]._keys, tee.stages["voxel"]._rows, tee.stages["voxel"]._sums))
        log(f"  {stats.chunks} chunks, {stats.points:,} points in {wall:.2f} s "
            f"({stats.points / wall / 1e6:.2f} M points/s): host parse of the stream alone "
            f"{parse_s:.2f} s; stages (s, to the card's end): "
            f"{json.dumps({k: round(v, 3) for k, v in tee.seconds.items()})}; {n_vox:,} voxels, "
            f"memory_bytes {state_bytes:,} (the card's state {device_state:,} B); launches "
            f"{ {k: v for k, v in counts.items() if v} } {clock()}")
        check(stats.chunks == n_chunks and stats.points == n_tile, "the stream lost chunks")
        check(counts["union_window_a"] == counts["union_window_b"] == n_chunks
              and only(counts, {"union_window_a": n_chunks, "union_window_b": n_chunks}),
              "kernels 1-2 did not launch once a chunk, or others launched")

        fresh = {"voxel": lambda: streaming.StreamingVoxelFilter(STREAM_VOXEL, device=dev),
                 "normals": lambda: streaming.StreamingDeviceMap(normals_of, STREAM_CHUNK, dev)}
        syncs = {k: host_syncs(lambda: make().process_chunk(keep[0]))
                 for k, make in fresh.items()}
        tee2 = Tee(stages(dev))
        prof_wall, busy, top = device_profile(lambda: tt.run_pipeline(
            tt.read_point_cloud_iter(ply, chunk_size=STREAM_CHUNK), tee2), warmup=0)
        log(f"  a second run under the profiler: {prof_wall:.0f} ms wall, device busy "
            f"{busy:.0f} ms (idle share {1 - busy / prof_wall:.3f}); host syncs a chunk "
            f"{json.dumps(syncs)}; top device entries "
            f"{json.dumps([(name, round(ms, 1), c) for name, ms, c in top[:5]])}")
        del tee2

        cpu_tee = Tee(stages(cpu, normals=False))
        cpu_res, cpu_stats_ms = timed(lambda: tt.run_pipeline(
            tt.read_point_cloud_iter(ply, chunk_size=STREAM_CHUNK), cpu_tee)[0])
        a, b = voxels.to_numpy(), cpu_res["voxel"].to_numpy()
        rows_equal = len(a) == len(b)
        diff = int((a != b).any(1).sum()) if rows_equal else -1
        ulp = ulps_apart(a, b) if rows_equal else -1
        sa, sb = res["statistics"], cpu_res["statistics"]
        rel = max(float(np.max(np.abs(np.asarray(sa[k], np.float64) - sb[k])
                               / np.maximum(np.abs(sb[k]), 1e-300)))
                  for k in ("mean", "std", "min", "max"))
        cos = []
        for i, chunk in keep.items():
            lo = i * STREAM_CHUNK
            card_n = res["normals"][lo:lo + len(chunk)]
            c = tt.PointCloud.from_numpy(chunk, capacity=STREAM_CHUNK, device=cpu)
            cpu_n = normals_of(c.points, c.mask)[:len(chunk)].numpy()
            ok = np.isfinite(card_n).all(1) & np.isfinite(cpu_n).all(1) & \
                (np.abs(cpu_n).sum(1) > 0)
            cos.append(float(np.abs((card_n[ok] * cpu_n[ok]).sum(1)).min()))
        log(f"  against the port's CPU run of the same stream ({cpu_stats_ms / 1e3:.1f} s, "
            f"voxel filter and statistics; normals of chunks {list(keep)}): voxel rows "
            f"{len(a):,} vs {len(b):,}, in the same order, {diff} rows differ, at most {ulp} "
            f"float32 ulp (gate 1); statistics within {rel:.2e} relative (gate "
            f"{STATS_REL_TOL}); normals |cos| min {min(cos):.6f} (gate {NORMALS_COS})")
        check(rows_equal and ulp <= 1, "the voxel rows differ from the CPU run's")
        check(rel <= STATS_REL_TOL and stats.points == sb["count"] == sa["count"],
              "the statistics differ from the CPU run's")
        check(min(cos) >= NORMALS_COS, "the chunk normals differ from the CPU run's")
        report["stream"] = {"chunks": stats.chunks, "points": stats.points, "wall_s": wall,
                            "host_parse_s": parse_s, "stage_s": tee.seconds, "voxels": n_vox,
                            "memory_bytes": state_bytes, "device_state_bytes": device_state,
                            "launches": {k: v for k, v in counts.items() if v},
                            "profiled_wall_ms": prof_wall, "busy_ms": busy,
                            "host_syncs_a_chunk": syncs, "cpu_s": cpu_stats_ms / 1e3,
                            "rows_differing": diff, "max_ulp": ulp, "stats_rel": rel,
                            "normals_cos_min": min(cos)}
        del res, voxels, cpu_res, tee, cpu_tee

        frames = ouster_frames()
        packets = [f[i:i + OUSTER_PACKET] for f in frames for i in range(0, len(f), OUSTER_PACKET)]
        n_rt = sum(len(p) for p in packets)
        rt = tt.RealtimeVoxelFilter(STREAM_VOXEL, device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for packet in packets:
            rt.send(packet)
        rt_out = rt.finish(timeout=600.0)
        rt_s = time.perf_counter() - t0
        m = rt.metrics
        ref = streaming.StreamingVoxelFilter(STREAM_VOXEL, device=dev)
        tt.run_pipeline([np.concatenate(frames)[i:i + STREAM_CHUNK]
                         for i in range(0, n_rt, STREAM_CHUNK)], ref)
        got = rt.pipeline
        keys_equal = torch.equal(got._keys, ref._keys)
        s1, s2 = got._sums[got._rows], ref._sums[ref._rows]
        counts_equal = keys_equal and torch.equal(s1[:, 3], s2[:, 3])
        c1 = (s1[:, :3] / s1[:, 3:]).float().cpu().numpy()
        c2 = (s2[:, :3] / s2[:, 3:]).float().cpu().numpy()
        rt_diff = int((c1 != c2).any(1).sum()) if keys_equal else -1
        rt_ulp = ulps_apart(c1, c2) if keys_equal else -1
        log(f"  RealtimeVoxelFilter({STREAM_VOXEL}) fed {OUSTER_FRAMES} OS1-128 frames "
            f"({n_rt:,} points in {len(packets)} packets of {OUSTER_PACKET}) by blocking send: "
            f"{rt_s:.2f} s, {n_rt / rt_s / 1e6:.3f} M points/s sustained; queued {m.queued}, "
            f"processed {m.processed}, dropped {m.dropped}; {len(rt_out):,} voxels; against "
            f"StreamingVoxelFilter on the same points sorted by key: keys and counts equal "
            f"{counts_equal}, {rt_diff} centroids differ, at most {rt_ulp} float32 ulp (gate 1) "
            f"{clock()}")
        check(m.processed == m.queued == len(packets) and m.dropped == 0,
              "the realtime pipeline lost packets")
        check(counts_equal and rt_ulp <= 1, "the realtime voxels differ from the streaming ones")
        # a chunk's merge on its own, on the card and in the JAX package's
        # host dict (copied): the first frame in packets and in the
        # pipeline's 256-point chunks, each from an empty state
        per_chunk = {}
        for size in (OUSTER_PACKET, streaming.BackpressureConfig().chunk_size):
            chunks = [frames[0][i:i + size] for i in range(0, len(frames[0]), size)]
            for name, make in (("card", lambda: streaming.StreamingVoxelFilter(STREAM_VOXEL,
                                                                                 device=dev)),
                               ("host dict", lambda: DictVoxelFilter(STREAM_VOXEL))):
                f = make()
                t0 = time.perf_counter()
                for c in chunks:
                    f.process_chunk(c)
                torch.cuda.synchronize()
                per_chunk[f"{name} {size}"] = 1e3 * (time.perf_counter() - t0) / len(chunks)
        log(f"  one chunk's merge alone, ms (one frame, from an empty state): "
            f"{json.dumps({k: round(v, 3) for k, v in per_chunk.items()})} {clock()}")
        report["realtime"] = {"points": n_rt, "packets": len(packets), "seconds": rt_s,
                              "points_per_s": n_rt / rt_s, "voxels": len(rt_out),
                              "centroids_differing": rt_diff, "chunk_ms": per_chunk}
        del rt, ref, got, frames, packets, chunks
        log(f"  phase {phase_seconds()}")

        # -- phase 46 -------------------------------------------------------
        log(f"phase 46: phase 42's street coloured from {COLOR_VIEWS} seeded "
            f"{COLOR_HW[1]}x{COLOR_HW[0]} uint8 views: colorize_point_cloud (nearest, bilinear) "
            f"and colorize_from_images over all six")
        street, _ = street_scene()
        rng = np.random.default_rng(COLOR_SEED)
        intr = tt.CameraIntrinsics(*COLOR_INTR)
        views = [tt.RgbImageView(rng.integers(0, 256, (*COLOR_HW, 3), dtype=np.uint8), intr, w2c)
                 for w2c in street_cameras()]
        card_c = tt.PointCloud.from_numpy(street, device=dev)
        host_c = tt.PointCloud.from_numpy(street, device=cpu)
        same_pixels, hits = True, []
        h, w = COLOR_HW
        for v in views:
            proj = [colorization._project(c.points, c.mask, *colorization._view_inputs(v, c.device)[1:],
                                          h, w) for c in (card_c, host_c)]
            same_pixels &= all(torch.equal(x.cpu(), y) for x, y in zip(*proj))
            hits.append(int(proj[1][2].sum()))
        colour = {}
        for mode in tt.InterpolationMode:
            for name, fn in (("view 0", lambda c: tt.colorize_point_cloud(c, views[0], mode)),
                             ("all six", lambda c: tt.colorize_from_images(c, views, mode))):
                card_out = no_kernel(lambda: fn(card_c))
                equal = torch.equal(card_out.colors.cpu(), fn(host_c).colors)
                colour[f"{name} {mode.value}"] = {"bit_equal": equal, **measure(lambda: fn(card_c))}
        log(f"  {len(street):,} points; points in each view {hits}; the card's (u, v) and "
            f"in-image flags bit-equal to the CPU run's in every view {same_pixels}; colours "
            f"bit-equal {json.dumps({k: v['bit_equal'] for k, v in colour.items()})}")
        for k, v in colour.items():
            log(f"  {k}: {v['ms']:.2f} ms median of 3 ({v['ms'] / (6 if 'six' in k else 1):.2f} "
                f"ms a view, images uploaded in the call), peak {v['peak_gib']:.3f} GiB, device "
                f"busy {v['busy_ms']:.2f} ms, {v['host_syncs']} host syncs {clock()}")
        check(same_pixels and all(v["bit_equal"] for v in colour.values()),
              "the colours differ from the CPU run's")
        report["colour"] = {"points": len(street), "hits": hits, **colour}
        del card_c, host_c
        log(f"  phase {phase_seconds()}")

        # -- phase 47 -------------------------------------------------------
        log("phase 47: the other formats at 1M: E57 (cartesian, spherical), rosbag2 .db3 and "
            f".mcap ({BAG_MESSAGES} PointCloud2 messages of {BAG_POINTS:,}), .tcz, .glb of phase "
            f"34's mesh, .npz artifacts of a cloud, that mesh and phase 27's volume")
        rng = np.random.default_rng(FORMATS_SEED)
        s_int = rng.uniform(0, 1, len(street)).astype(np.float32)
        s_rgb = rng.uniform(0, 1, (len(street), 3)).astype(np.float32)
        s_host = tt.PointCloud.from_numpy(street, intensity=s_int, colors=s_rgb, device=cpu)
        formats = {}
        for kind, kw in (("cartesian", {}), ("spherical", {"spherical": True})):
            path = tmp / f"street_{kind}.e57"
            _, wms = timed(lambda: e57.write_point_cloud(path, s_host, **kw))
            back, rms = timed(lambda: no_kernel(lambda: tt.read_point_cloud(path)))
            got = host(back)
            if kind == "cartesian":
                ok = same(got, {"points": street, "intensity": s_int})
                what = "points and intensity bit-equal"
            else:
                ulp = ulps_apart(got["points"], street)
                ok = ulp <= 2 and np.array_equal(got["intensity"], s_int)
                what = f"points within {ulp} float32 ulp (gate 2: float64 trigonometry), " \
                       f"intensity bit-equal"
            log(f"  E57 {kind}: {path.stat().st_size / 2**20:.1f} MiB written in {wms:.0f} ms, "
                f"read onto {back.device} in {rms:.0f} ms; {what} {ok}")
            check(ok and back.device.type == "cuda", f"the {kind} E57 read back wrong")
            formats[f"e57 {kind}"] = {"write_ms": wms, "read_ms": rms}

        bag_pts = pts[:BAG_MESSAGES * BAG_POINTS]
        bag_int = inten[:len(bag_pts)]
        bag_rgb = np.round(rgb[:len(bag_pts)] * 255).astype(np.uint8)
        msgs = [pointcloud2_cdr(bag_pts[i * BAG_POINTS:(i + 1) * BAG_POINTS],
                                bag_int[i * BAG_POINTS:(i + 1) * BAG_POINTS],
                                bag_rgb[i * BAG_POINTS:(i + 1) * BAG_POINTS], i)
                for i in range(BAG_MESSAGES)]
        imu = [rng.integers(0, 256, 300, dtype=np.uint8).tobytes() for _ in range(3)]
        for ext, writer in (("db3", write_bag), ("mcap", write_mcap)):
            path = tmp / f"ride.{ext}"
            _, wms = timed(lambda: writer(path, msgs, imu))
            for topic in (None, BAG_TOPIC):
                back, rms = timed(lambda: no_kernel(lambda: tt.read_point_cloud(path,
                                                                                topic=topic)))
                ok = np.array_equal(back.to_numpy(), bag_pts) and back.device.type == "cuda"
                log(f"  .{ext} ({path.stat().st_size / 2**20:.1f} MiB written in {wms:.0f} ms), "
                    f"topic={topic!r}: read onto {back.device} in {rms:.0f} ms; "
                    f"{len(back):,} points bit-equal to those written {ok}")
                check(ok, f"the .{ext} read back wrong")
                formats[f"{ext} topic={topic}"] = {"write_ms": wms, "read_ms": rms}
            reader = (rosbag.Rosbag2Reader if ext == "db3" else rosbag.McapReader)(path)
            first = reader.read_clouds(max_messages=1)[0]
            ok = (np.array_equal(first.attr_to_numpy("intensity"), bag_int[:BAG_POINTS])
                  and np.array_equal(first.attr_to_numpy("colors"),
                                     bag_rgb[:BAG_POINTS].astype(np.float32) / 255.0)
                  and first.device.type == "cuda")
            log(f"  .{ext} first message's intensity and RGB bit-equal {ok}")
            check(ok, f"the .{ext} message attributes read back wrong")
            if ext == "db3":
                reader.close()

        path = tmp / "street.tcz"
        _, wms = timed(lambda: tt.write_point_cloud(path, s_host))
        back, rms = timed(lambda: no_kernel(lambda: tt.read_point_cloud(path)))
        got = host(back)
        p64 = street.astype(np.float64)
        mn, ext = p64.min(0), np.maximum(p64.max(0) - p64.min(0), 1e-12)
        scale = ((1 << 14) - 1) / ext
        qa = np.round((p64 - mn) * scale).astype(np.int64)
        qb = np.round((got["points"].astype(np.float64) - mn) * scale).astype(np.int64)
        oa, ob = np.lexsort(qa.T[::-1]), np.lexsort(qb.T[::-1])
        lattice = np.array_equal(qa[oa], qb[ob])
        # the decoded points of one lattice cell are one point, within half
        # a step (and the float32 rounding of the decode) of each original
        bound = 0.5 / scale + np.spacing(np.abs(street).max(0)).astype(np.float64)
        err = np.abs(got["points"][ob].astype(np.float64) - p64[oa]).max(0) if lattice \
            else np.full(3, np.inf)
        within = bool((err <= bound).all())

        def rgb_codes(q8):
            q8 = q8.astype(np.int64)
            return np.sort((q8[:, 0] << 16) | (q8[:, 1] << 8) | q8[:, 2])
        # the codec's 8-bit colours: c·255 + 0.5 truncated
        attrs_ok = np.array_equal(np.sort(got["intensity"]), np.sort(s_int)) and np.array_equal(
            rgb_codes(np.round(got["colors"] * 255)),
            rgb_codes(np.clip(s_rgb * 255 + 0.5, 0, 255).astype(np.uint8)))
        log(f"  .tcz: {path.stat().st_size / 2**20:.1f} MiB "
            f"({path.stat().st_size / (12 * len(street)):.3f} of the xyz float32 bytes) written "
            f"in {wms:.0f} ms, read onto {back.device} in {rms:.0f} ms; the 14-bit lattice of "
            f"the points equal {lattice}, each within {err.tolist()} m of its cell's (bound "
            f"half a step and an fp32 ulp: {bound.tolist()}) {within}; intensities and 8-bit "
            f"colours equal as multisets (the codec reorders points) {attrs_ok}")
        check(lattice and within and attrs_ok and back.device.type == "cuda",
              "the .tcz read back wrong")
        formats["tcz"] = {"write_ms": wms, "read_ms": rms, "bytes": path.stat().st_size}

        mesh = welded_mesh(tt, dev)
        path = tmp / "mesh.glb"
        _, wms = timed(lambda: tt.write_mesh(path, mesh))
        back, rms = timed(lambda: no_kernel(lambda: tt.read_mesh(path)))
        ok = all(np.array_equal(a, b) for a, b in zip(back.to_numpy(), mesh.to_numpy()))
        log(f"  .glb of phase 34's mesh ({int(mesh.face_count()):,} faces): written in {wms:.0f} "
            f"ms, read onto {back.device} in {rms:.0f} ms; vertices and faces bit-equal {ok}")
        check(ok and back.device.type == "cuda", "the .glb read back wrong")
        formats["glb"] = {"write_ms": wms, "read_ms": rms}

        card_cloud = tt.PointCloud.from_numpy(street, intensity=s_int, colors=s_rgb, device=dev)
        volume = dense_volume(tt, dev)
        for name, obj in (("cloud", card_cloud), ("mesh", mesh), ("volume", volume)):
            path = tmp / f"{name}.npz"
            _, wms = timed(lambda: artifacts.save_artifact(path, obj))
            back, rms = timed(lambda: no_kernel(lambda: artifacts.load_artifact(path)))
            if name == "volume":
                pairs = list(zip(back, obj))
            else:
                keys = ("points", "mask") if name == "cloud" else \
                    ("vertices", "faces", "vertex_mask", "face_mask")
                pairs = [(getattr(back, k), getattr(obj, k)) for k in keys] + \
                    [(back.attrs[k], obj.attrs[k]) for k in obj.attrs]
            ok = all((x is None and y is None) or (x.device.type == "cuda" and torch.equal(x, y))
                     for x, y in pairs) and type(back) is type(obj)
            log(f"  .npz artifact of the {name}: {path.stat().st_size / 2**20:.1f} MiB written in "
                f"{wms:.0f} ms, loaded onto the card in {rms:.0f} ms; every tensor equal {ok}")
            check(ok, f"the {name} artifact loaded back wrong")
            formats[f"npz {name}"] = {"write_ms": wms, "read_ms": rms}
        log(f"  {clock()}")
        report["formats"] = formats
        del mesh, volume, card_cloud
        log(f"  phase {phase_seconds()}")
    return total, report


def counted_call(kernels, total, fn, expect=None):
    """One gated call of ``fn`` under ``torch.profiler``: (output, {ms,
    busy_ms, idle_share, peak_gib, host_syncs, device_ops, launches}), the
    launch counts checked against ``expect`` (no kernel by default). The
    wall time is the profiled call's (CUDA activity only), host syncs are
    counted by ``torch.cuda.set_sync_debug_mode`` in the same call,
    ``device_ops`` are the call's device kernels, copies and memsets."""
    from threecrate_tpu_torch.utils.profiling import device_profile

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    caught, result = [], {}

    def traced():
        with warnings.catch_warnings(record=True) as got:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                result["out"] = fn()
            finally:
                torch.cuda.set_sync_debug_mode("default")
                caught.extend(got)

    (wall, busy, entries), counts = run_counted(
        kernels, total, lambda: device_profile(traced, top=None, warmup=0))
    nums = {"ms": wall, "busy_ms": busy, "idle_share": 1.0 - busy / wall,
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
            "host_syncs": sum("synchroniz" in str(w.message) for w in caught),
            "device_ops": sum(c for _, _, c in entries),
            "launches": {k: n for k, n in counts.items() if n}}
    check(only(counts, expect or {}), f"launches {counts}, expected exactly {expect or 'none'}")
    return result["out"], nums


def parallel_phases(dev, kernels):
    """Phases 48-51: the multi-shard points axis (``parallel``), eight shards
    of one mesh on the card, each entry gated against the port's
    single-device path on the card. Kernel 4 (``window_normals``) is the
    slice's one kernel: once a shard in the window normals; the ring paths
    launch none. Each entry's gated call runs under ``torch.profiler``:
    its wall ms with a synchronise, device busy time, peak allocated and
    the host syncs counted in that call. Returns
    (launches, numbers for the log)."""
    import threecrate_tpu_torch as tt
    from threecrate_tpu_torch import parallel as tp
    from threecrate_tpu_torch.ops import features, morton, neighbors
    from threecrate_tpu_torch.ops.normals import _pca_normals
    from threecrate_tpu_torch.utils.profiling import device_profile

    total = dict.fromkeys(kernels.WRAPPERS, 0)
    report = {"card": card_line(), "shards": SHARDS}
    mesh = tp.make_mesh(SHARDS, devices=[dev] * SHARDS)
    t_phase = time.perf_counter()

    def phase_seconds():
        nonlocal t_phase
        t, t_phase = time.perf_counter() - t_phase, time.perf_counter()
        return f"{t:.1f} s"

    def counted(fn, expect=None):
        return counted_call(kernels, total, fn, expect)

    def fmt(nums):
        return (f"{nums['ms']:.1f} ms a call (busy {nums['busy_ms']:.1f} ms), "
                f"peak {nums['peak_gib']:.3f} GiB, {nums['host_syncs']} host syncs, launches "
                f"{nums['launches'] or 'none'}")

    def rot_err(t, rot):
        return float(np.abs(t[:3, :3] - rot).max())

    # -- phase 48 --------------------------------------------------------------
    log(f"phase 48: make_distributed_morton_sort and make_sharded_normals_window on "
        f"{N_SHARDED:,} shuffled points, {SHARDS} shards on {dev} ({report['card']}, SM clock "
        f"{sm_clock()})")
    pts = scan(N_SHARDED, 0)[np.random.default_rng(SHARD_SEED).permutation(N_SHARDED)]
    p = torch.from_numpy(pts).to(dev)
    m = torch.ones(N_SHARDED, dtype=torch.bool, device=dev)
    sort_fn = tp.make_distributed_morton_sort(mesh)
    (spts, smask, gid), n_sort = counted(lambda: sort_fn(p, m))
    spts, smask, gid = spts.gather(), smask.gather(), gid.gather().long()
    keys = morton.morton_keys(p, m, 0)
    stable = torch.sort(keys, stable=True)
    is_perm = torch.equal(torch.sort(gid).values, torch.arange(N_SHARDED, device=dev))
    rows = torch.equal(spts, p[gid]) and bool(smask.all())
    key_seq = torch.equal(keys[gid], stable.values)
    in_order = torch.equal(gid, stable.indices)
    distinct = torch.unique(keys).numel()
    log(f"  sort: gid a permutation {is_perm}, points == pts[gid] {rows}, keys equal to the "
        f"stable sort's {key_seq}, ties in input order {in_order} ({distinct:,} distinct keys of "
        f"{N_SHARDED:,}); {fmt(n_sort)}")
    check(is_perm and rows and key_seq and in_order, "the distributed sort is not the stable sort")
    del spts, smask, stable

    nw_fn = tp.make_sharded_normals_window(mesh, k=K_NORMALS, tile=256, band=16)
    (nrm, valid), n_win = counted(lambda: nw_fn(p, m), {"window_normals": SHARDS})
    nrm, valid = nrm.gather(), valid.gather()
    spts_np, smask_np, perm = tp.morton_presort(p, m, SHARDS, tile=256)
    sp, sm = torch.from_numpy(spts_np).to(dev), torch.from_numpy(smask_np).to(dev)
    perm = torch.from_numpy(perm).to(dev).long()
    pre_fn = tp.make_sharded_normals_window(mesh, k=K_NORMALS, tile=256, band=16, presorted=True)
    (nrm_s, val_s), n_pre = counted(lambda: pre_fn(sp, sm), {"window_normals": SHARDS})
    back_n, back_v = torch.zeros_like(p), torch.zeros_like(m)
    back_n[perm], back_v[perm] = nrm_s.gather(), val_s.gather()
    routed = torch.equal(nrm, back_n) and torch.equal(valid, back_v)
    # exact k = 10 normals of a strided subset, as phase 18 forms them
    sub = torch.arange(0, N_SHARDED, N_SHARDED // 16384, device=dev)[:16384]
    q = p[sub]
    cand = neighbors.knn(p, m, q, None, 16)
    d = torch.where(cand.mask, (p[cand.indices] - q[:, None]).norm(dim=-1), torch.inf)
    d, order = torch.sort(d, dim=1)
    idx = torch.gather(cand.indices, 1, order)[:, :K_NORMALS]
    ok = torch.isfinite(d[:, :K_NORMALS])
    exact_n, exact_c = _pca_normals(p[idx], ok, q, torch.zeros(3, device=dev), True)
    both = valid[sub] & (ok.sum(1) >= 3)
    planar = both & (exact_c < PLANAR_CURVATURE)
    ang = angle_deg(exact_n, nrm[sub])
    mean_all, mean_planar = ang[both].mean().item(), ang[planar].mean().item()
    # the same kernel on one device, one Morton pass, no shard seams
    one = tt.estimate_normals_detailed(tt.PointCloud.from_points(p), tt.NormalEstimationConfig(
        k_neighbors=K_NORMALS, method="window_fast", window_passes=1, viewpoint=(0.0, 0.0, 0.0)))
    one_ang = angle_deg(exact_n, one.normals[sub])
    one_planar = one_ang[planar & one.valid[sub]].mean().item()
    v_share = valid.float().mean().item()
    n_win["mpts_s"] = N_SHARDED / n_win["ms"] / 1e3
    log(f"  window normals: window_normals launched {n_win['launches']} (need {SHARDS}); valid "
        f"share {v_share:.5f}; shuffled input equal to the presorted call routed back by perm, "
        f"bit for bit, {routed}; mean angle to exact k=10 normals on {int(both.sum())} of 16,384 "
        f"sampled points {mean_all:.4f} deg, on the {int(planar.sum())} planar ones (curvature < "
        f"{PLANAR_CURVATURE}) {mean_planar:.4f} deg (need < 0.5, or within {SEAM_TOL_DEG} of the "
        f"single-device one-pass window_fast's {one_planar:.4f}: one Morton pass, as the JAX "
        f"entry runs); {fmt(n_win)}; presorted call {fmt(n_pre)}")
    check(routed and v_share > 0.99 and mean_planar < max(0.5, one_planar + SEAM_TOL_DEG),
          "sharded window normals disagree with the presorted path or the exact normals")
    t_sort, t_win = measure(lambda: sort_fn(p, m)), measure(lambda: nw_fn(p, m))
    log(f"  steady state (median of 3 after a warm-up): sort {t_sort['ms']:.2f} ms (busy "
        f"{t_sort['busy_ms']:.2f}, {t_sort['host_syncs']} syncs), window normals "
        f"{t_win['ms']:.2f} ms (busy {t_win['busy_ms']:.2f}, {t_win['host_syncs']} syncs, "
        f"{N_SHARDED / t_win['ms'] / 1e3:.1f} Mpts/s); peak {t_win['peak_gib']:.3f} GiB")
    report["phase48"] = {"sort": n_sort, "sort_steady": t_sort, "window_normals": n_win,
                         "window_normals_steady": t_win, "presorted": n_pre,
                         "distinct_keys": distinct, "valid_share": v_share,
                         "mean_angle_deg": mean_all, "planar_mean_angle_deg": mean_planar,
                         "one_pass_planar_mean_angle_deg": one_planar}
    del nrm, valid, nrm_s, val_s, back_n, back_v, sp, sm, perm, cand, d, idx, one
    log(f"  phase {phase_seconds()}")

    # -- phase 49 --------------------------------------------------------------
    log(f"phase 49: make_sharded_voxel_filter({VOXEL}) on phase 48's {N_SHARDED:,} points; "
        f"make_sharded_outlier_stats(k={SOR_K}) at {N_RING:,}")
    vox_fn = tp.make_sharded_voxel_filter(mesh, VOXEL)
    (cent, cmask), n_vox = counted(lambda: vox_fn(p, m))
    cent, cmask = cent.gather(), cmask.gather()
    cloud = tt.PointCloud.from_points(p)
    ref = tt.voxel_grid_filter_detailed(cloud, VOXEL)
    same_mask = torch.equal(cmask, ref.cloud.mask)
    # float64 centroids of the single-device path's voxels (its rows, its
    # inverse): both fp32 paths are held against them
    nv = int(ref.num_voxels)
    inv = ref.voxel_index.long()
    cnt64 = torch.bincount(inv, minlength=nv).to(torch.float64)
    c64 = torch.zeros(nv, 3, dtype=torch.float64, device=dev).index_add_(
        0, inv, p.to(torch.float64)) / cnt64[:, None]
    err_single = (ref.cloud.points[:nv] - c64).abs().max().item()
    err = (cent[:nv] - c64).abs().max().item() if same_mask else math.inf
    t_vox = measure(lambda: vox_fn(p, m))
    t_single = measure(lambda: tt.voxel_grid_filter(cloud, VOXEL))
    top = [(name, round(ms, 3), n) for name, ms, n in device_profile(lambda: vox_fn(p, m), 6)[2]]
    log(f"  voxels {int(cmask.sum()):,} (tt.voxel_grid_filter: {nv:,}), the same rows valid "
        f"{same_mask}, centroids within {err:.3e} m of the float64 centroids (need <= "
        f"max({VOXEL_TOL}, 2 x the single-device path's {err_single:.3e})); {fmt(n_vox)}; steady "
        f"{t_vox['ms']:.2f} ms (busy {t_vox['busy_ms']:.2f}, {t_vox['host_syncs']} syncs) against "
        f"tt.voxel_grid_filter's {t_single['ms']:.2f} ms (busy {t_single['busy_ms']:.2f}); "
        f"largest device entries {top}")
    check(same_mask and err <= max(VOXEL_TOL, 2.0 * err_single),
          "the sharded voxel filter disagrees")
    report["phase49"] = {"voxel": n_vox, "voxel_steady": t_vox, "single_steady": t_single,
                         "voxels": int(cmask.sum()), "centroid_err_m": err,
                         "single_centroid_err_m": err_single, "top": top}
    del cent, cmask, ref, p, m, keys, gid, cloud, inv, c64, cnt64

    ring = torch.from_numpy(scan(N_RING, 0)).to(dev)
    rm = torch.ones(N_RING, dtype=torch.bool, device=dev)
    sor_fn = tp.make_sharded_outlier_stats(mesh, SOR_K)
    keep, n_sor = counted(lambda: sor_fn(ring, rm, SOR_STD))
    keep = keep.gather()
    res = neighbors.knn(ring, rm, ring, rm, SOR_K + 1)
    fin = torch.isfinite(res.distances)
    mean_d = torch.where(fin, res.distances, 0.0).sum(1) / (fin.sum(1) - 1).clamp_min(1)
    mu = mean_d.mean()
    keep_ref = mean_d <= mu + SOR_STD * ((mean_d - mu) ** 2).mean().sqrt()
    agree = (keep == keep_ref).float().mean().item()
    log(f"  outlier stats: kept {int(keep.sum()):,} of {N_RING:,} (neighbors.knn's mean "
        f"distances: {int(keep_ref.sum()):,}), masks equal on {agree:.6f} (need >= 0.999); "
        f"{fmt(n_sor)}")
    check(agree >= 0.999, "the sharded outlier mask disagrees with knn's")
    report["phase49"]["outlier_stats"] = {**n_sor, "kept": int(keep.sum()), "agree": agree}
    log(f"  phase {phase_seconds()}")

    # -- phase 50 --------------------------------------------------------------
    log(f"phase 50: ring kNN, ring normals and the ICP family at {N_RING:,} points")
    knn_fn = tp.make_sharded_knn(mesh, RING_K)
    (rd, ri), n_knn = counted(lambda: knn_fn(ring, ring, rm))
    rd, ri = rd.gather(), ri.gather().long()
    ref = neighbors.knn(ring, rm, ring, rm, RING_K)
    sq = (ring * ring).sum(1)
    ulp = 2.0 ** -23 * (sq[:, None] + sq[ref.indices])
    d2_ulps = ((rd ** 2 - ref.distances ** 2).abs() / ulp).max().item()
    gap = ref.distances.diff(dim=1) > 1e-5
    apart = torch.ones_like(gap[:, :1]).expand(-1, RING_K).clone()
    apart[:, :-1] &= gap
    apart[:, 1:] &= gap
    ids_eq = (ri == ref.indices)[apart].float().mean().item()
    log(f"  ring kNN k={RING_K}: d2 within {d2_ulps:.2f} ulps of |q|^2 + |p|^2 of knn's (need <= "
        f"{D2_ULPS}), ids equal on {ids_eq:.6f} of the slots whose distances are apart (need "
        f">= 0.999); {fmt(n_knn)}")
    check(d2_ulps <= D2_ULPS and ids_eq >= 0.999, "the ring kNN disagrees with knn")

    nrm_fn = tp.make_sharded_normals(mesh, k=RING_K)
    rn, n_rn = counted(lambda: nrm_fn(ring, rm))
    rn = rn.gather()
    ref = tt.estimate_normals_detailed(tt.PointCloud.from_points(ring), tt.NormalEstimationConfig(
        k_neighbors=RING_K + 1, method="exact", viewpoint=(0.0, 0.0, 0.0)))
    ok = ref.valid & (rn.norm(dim=1) > 0)
    cos = (rn * ref.normals).sum(1)[ok]
    cos_share = (cos >= 0.9999).float().mean().item()
    log(f"  ring normals k={RING_K}: |cos| >= 0.9999 (orientation included) to the exact path at "
        f"k={RING_K + 1} (the same neighbourhood with its self match) on {cos_share:.6f} of "
        f"{int(ok.sum()):,} valid points (need >= 0.999); {fmt(n_rn)}")
    check(cos_share >= 0.999, "ring normals disagree with the exact path")
    report["phase50"] = {"knn": {**n_knn, "d2_ulps": d2_ulps, "ids_equal": ids_eq},
                         "normals": {**n_rn, "cos_share": cos_share}}
    del rd, ri, ref, rn

    src_c = tt.PointCloud.from_points(ring)
    tgt_pts = ring + torch.from_numpy(SHIFT).to(dev)
    tgt_c = tt.estimate_normals(tt.PointCloud.from_points(tgt_pts), k=K_NORMALS)
    singles = {
        "icp": lambda: tt.icp_point_to_point(src_c, tgt_c, RING_ICP_ITERS).transformation,
        "p2plane": lambda: tt.ops.registration.icp_point_to_plane(
            src_c, tgt_c, RING_ICP_ITERS).transformation,
        "gicp": lambda: tt.ops.gicp.gicp(src_c, tgt_c, tt.GicpConfig(
            max_iterations=RING_ICP_ITERS)).transformation}
    sharded = {
        "icp": (tp.make_sharded_icp(mesh, RING_ICP_ITERS), (ring, rm, tgt_pts, rm)),
        "p2plane": (tp.make_sharded_icp_p2plane(mesh, RING_ICP_ITERS),
                    (ring, rm, tgt_pts, rm, tgt_c.normals)),
        "gicp": (tp.make_sharded_gicp(mesh, RING_ICP_ITERS, max_correspondence_distance=1.0),
                 (ring, rm, tgt_pts, rm))}
    for name, (fn, args) in sharded.items():
        (t, mse, it, conv), nums = counted(lambda: fn(*args))
        t = t.cpu().numpy()
        ts = singles[name]().cpu().numpy()
        shift_err = float(np.abs(t[:3, 3] - SHIFT).max())
        vs_single = float(np.abs(t - ts).max())
        nums.update({"iterations": int(it), "converged": bool(conv), "mse": float(mse),
                     "shift_err_m": shift_err, "rot_err": rot_err(t, np.eye(3)),
                     "vs_single": vs_single, "ms_an_iteration": nums["ms"] / max(int(it), 1)})
        log(f"  sharded {name}: translation {t[:3, 3].tolist()} ({int(it)} iterations, converged "
            f"{bool(conv)}, mse {float(mse):.3e}), shift within {shift_err:.2e} m and rotation "
            f"within {nums['rot_err']:.2e} (need <= {RING_POSE_TOL}), the single-device pose "
            f"within {vs_single:.2e} (need <= {RING_POSE_TOL}); {fmt(nums)}")
        check(shift_err <= RING_POSE_TOL and nums["rot_err"] <= RING_POSE_TOL
              and vs_single <= RING_POSE_TOL, f"sharded {name} missed the pose")
        report["phase50"][name] = nums

    bmesh = tp.Mesh(np.array([dev] * SHARDS, dtype=object).reshape(2, SHARDS // 2),
                    ("batch", "points"))
    base = scan(BATCH_POINTS, 1)
    src_b = torch.from_numpy(np.stack([base, base])).to(dev)
    tgt_b = src_b + torch.from_numpy(BATCH_SHIFTS).to(dev)[:, None, :]
    mb = torch.ones(2, BATCH_POINTS, dtype=torch.bool, device=dev)
    batch_fn = tp.make_sharded_batch_icp(bmesh, RING_ICP_ITERS)
    (bt, _, bit, _), n_b = counted(lambda: batch_fn(src_b, mb, tgt_b, mb))
    bt, bit = bt.gather().cpu().numpy(), bit.gather().cpu().numpy()
    b_err = float(np.abs(bt[:, :3, 3] - BATCH_SHIFTS).max())
    log(f"  sharded batch ICP on a 2 x {SHARDS // 2} mesh, two {BATCH_POINTS:,}-point pairs: "
        f"shifts within {b_err:.2e} m (need <= {BATCH_POSE_TOL}), iterations {bit.tolist()}; "
        f"{fmt(n_b)}")
    check(b_err <= BATCH_POSE_TOL, "sharded batch ICP missed a shift")
    report["phase50"]["batch_icp"] = {**n_b, "shift_err_m": b_err, "iterations": bit.tolist()}
    del src_b, tgt_b, src_c, tgt_c
    log(f"  ({report['card']}, SM clock {sm_clock()})")
    log(f"  phase {phase_seconds()}")

    # -- phase 51 --------------------------------------------------------------
    log(f"phase 51: the sharded FPFH -> matching -> RANSAC chain at {N_RING:,} points, the "
        f"registration pair's rotation ({REG_ANGLE} rad) and shift {REG_SHIFT.tolist()}")
    tgt_np = scan(N_RING, 3)
    c, s = np.cos(REG_ANGLE), np.sin(REG_ANGLE)
    rot = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
    tgt = torch.from_numpy(tgt_np).to(dev)
    src = torch.from_numpy((tgt_np @ rot.T + REG_SHIFT).astype(np.float32)).to(dev)
    normals_fn = tp.make_sharded_normals(mesh, k=K_NORMALS)
    fpfh_fn = tp.make_sharded_fpfh(mesh, RING_FPFH_RADIUS, k=RING_FPFH_K)
    tn, sn = normals_fn(tgt, rm), normals_fn(src, rm)
    (td, tv), n_fpfh = counted(lambda: fpfh_fn(tgt, rm, tn))
    sd, sv = fpfh_fn(src, rm, sn)
    ref_d, ref_v = features._fpfh(tgt, rm, tn.gather(), RING_FPFH_RADIUS, RING_FPFH_K, 11)
    tdg, tvg = td.gather(), tv.gather()
    both = tvg & ref_v
    na = tdg[both] / tdg[both].norm(dim=1, keepdim=True).clamp_min(1e-9)
    nb = ref_d[both] / ref_d[both].norm(dim=1, keepdim=True).clamp_min(1e-9)
    fcos = (na * nb).sum(1)
    f_med, f_mean = fcos.median().item(), fcos.mean().item()
    log(f"  sharded FPFH (r = {RING_FPFH_RADIUS}, k = {RING_FPFH_K}) against the single-device "
        f"staged _fpfh on the same normals: valid {int(tvg.sum()):,} / {int(ref_v.sum()):,}, "
        f"cosine median {f_med:.6f} (need >= 0.999) and mean {f_mean:.6f} (need >= 0.99; "
        f"tests/test_parallel.py's bounds: the sharded form keeps a self pair whose expanded d2 "
        f"rounds above 1e-18); {fmt(n_fpfh)}")
    check(f_med >= 0.999 and f_mean >= 0.99, "sharded FPFH disagrees with the staged FPFH")

    match_fn = tp.make_sharded_match_descriptors(mesh)
    (mj, mdist, mok, mpts), n_match = counted(lambda: match_fn(sd, sv, td, tv, tgt))
    mj, mdist, mok = mj.gather().long(), mdist.gather(), mok.gather()
    sdg = sd.gather()
    rj, rdist, rok = features.match_descriptors(sdg, sv.gather(), tdg, tvg)
    same_ok = torch.equal(mok, rok)
    ids_eq = (mj == rj)[mok].float().mean().item()
    # d2 in ulps of |a|^2 + |b|^2: the pair's descriptors are near copies, so
    # d is the square root of the expanded d2's rounding
    ulp = 2.0 ** -23 * ((sdg * sdg).sum(1) + (tdg[rj] * tdg[rj]).sum(1))
    d_ulps = ((mdist ** 2 - rdist ** 2).abs() / ulp)[mok].max().item()
    payload = torch.equal(mpts.gather()[mok], tgt[mj[mok]])
    log(f"  sharded matching: ok equal {same_ok}, ids equal on {ids_eq:.6f} (need >= 0.99: "
        f"equal descriptors tie), d2 within {d_ulps:.2f} ulps of |a|^2 + |b|^2 of "
        f"match_descriptors' (need <= {D2_ULPS}), matched points the target's rows {payload}; "
        f"{fmt(n_match)}")
    check(same_ok and ids_eq >= 0.99 and d_ulps <= D2_ULPS and payload,
          "sharded matching disagrees with match_descriptors")

    reg_fn = tp.make_sharded_global_registration(mesh, fpfh_radius=RING_FPFH_RADIUS,
                                                 k_fpfh=RING_FPFH_K)
    (t, count, ratio), n_reg = counted(lambda: reg_fn(src, rm, tgt, rm))
    t = t.cpu().numpy()
    # t maps the source onto the target: R' = rot^T, t' = -rot^T shift
    t_err = float(np.abs(t[:3, 3] + rot.T @ REG_SHIFT).max())
    r_err = rot_err(t, rot.T)
    log(f"  sharded global registration: inliers {int(count):,} (ratio {float(ratio):.4f}), "
        f"rotation within {r_err:.2e} and translation within {t_err:.2e} m of the truth (need <= "
        f"{BATCH_POSE_TOL}); {fmt(n_reg)}")
    check(r_err <= BATCH_POSE_TOL and t_err <= BATCH_POSE_TOL,
          "sharded global registration missed the pose")
    report["phase51"] = {"fpfh": {**n_fpfh, "cos_median": f_med, "cos_mean": f_mean},
                         "match": {**n_match, "ids_equal": ids_eq, "d2_ulps": d_ulps},
                         "registration": {**n_reg, "rot_err": r_err, "trans_err_m": t_err,
                                          "inliers": int(count), "ratio": float(ratio)}}
    log(f"  ({report['card']}, SM clock {sm_clock()})")
    log(f"  phase {phase_seconds()}")
    return total, report


def slab_phases(dev, kernels):
    """Phases 55-58: the last of ``parallel`` on eight shards of one mesh on
    the card (the algorithm, not an interconnect): the x-slab TSDF with its
    raycast, ``ShardedFrameToModelOdometry``, the sharded NDT, ground,
    clusters, SHOT / USC, plane RANSAC, MLS and colorize, and the x-slab
    Poisson. No kernel lies on these paths. Each entry is gated against the
    port's single-device entry on the card; its gated call runs under
    ``torch.profiler`` (``counted_call``). Returns (launches, numbers for
    the log)."""
    import threecrate_tpu_torch as tt
    from threecrate_tpu_torch import parallel as tp
    from threecrate_tpu_torch.ops import ndt as ndt_mod
    from threecrate_tpu_torch.ops import tsdf_raycast as ray_mod
    from threecrate_tpu_torch.ops import tsdf_sparse as sp_mod
    from threecrate_tpu_torch.ops.colorization import RgbImageView
    from threecrate_tpu_torch.reconstruction import multigrid
    from threecrate_tpu_torch.reconstruction import poisson as poisson_mod

    total = dict.fromkeys(kernels.WRAPPERS, 0)
    report = {"card": card_line(), "shards": SHARDS}
    mesh = tp.make_mesh(SHARDS, devices=[dev] * SHARDS)
    t_phase = time.perf_counter()
    h, w = DEPTH_HW

    def phase_seconds():
        nonlocal t_phase
        t, t_phase = time.perf_counter() - t_phase, time.perf_counter()
        report.setdefault("phase_s", []).append(round(t, 1))
        return f"{t:.1f} s"

    def counted(fn):
        return counted_call(kernels, total, fn)

    def fmt(nums):
        return (f"{nums['ms']:.1f} ms (busy {nums['busy_ms']:.1f} ms, idle "
                f"{nums['idle_share']:.3f}), peak {nums['peak_gib']:.3f} GiB, "
                f"{nums['host_syncs']} host syncs, {nums['device_ops']} device ops, launches "
                f"{nums['launches'] or 'none'}")

    def point_set(pts, mask):
        rows = pts[mask].cpu().numpy()
        return np.sort(np.ascontiguousarray(rows.round(5)).view([("", np.float32)] * 3),
                       axis=None)

    # -- phase 55 --------------------------------------------------------------
    log(f"phase 55: make_sharded_tsdf of the {h}x{w} wavy frame, {TSDF_GRID} blocks of 8 "
        f"({TSDF_VOXEL} m voxels, {TSDF_GRID[0] // SHARDS} block columns a shard), "
        f"{SLAB_BLOCKS} blocks a shard ({report['card']}, SM clock {sm_clock()})")
    depth, intr, eye = (torch.from_numpy(x).to(dev) for x in
                        (wavy_depth(), DEPTH_INTR, np.eye(4, dtype=np.float32)))
    fac = tp.make_sharded_tsdf(mesh, TSDF_GRID, TSDF_VOXEL, origin=TSDF_ORIGIN,
                               max_blocks_per_shard=SLAB_BLOCKS, update_fraction=1.0)
    st0 = fac.init()
    st, n_int = counted(lambda: fac.integrate(st0, depth, intr, eye))
    ref = sp_mod.sparse_integrate(
        sp_mod.create_sparse_volume(TSDF_VOXEL, origin=TSDF_ORIGIN, grid_blocks=TSDF_GRID,
                                    max_blocks=SHARDS * SLAB_BLOCKS, device=dev),
        depth, intr, eye, grid_blocks=TSDF_GRID, update_fraction=1.0)
    n = int(ref.n_blocks)
    keys = st.block_keys.gather()
    live = keys != 2 ** 31 - 1
    order = torch.argsort(keys[live])
    keys_eq = torch.equal(keys[live][order], ref.block_keys[:n])
    counts = st.n_blocks.gather().cpu().numpy()
    t_err = (st.tsdf.gather()[live][order] - ref.tsdf[:n]).abs().max().item()
    w_err = (st.weight.gather()[live][order] - ref.weight[:n]).abs().max().item()
    surf, n_surf = counted(lambda: fac.extract_surface(st))
    one = sp_mod.sparse_extract_surface(ref, TSDF_GRID)
    surf_eq = np.array_equal(point_set(surf[0].gather(), surf[1].gather()),
                             point_set(one.cloud.points, one.cloud.mask))
    soup, n_mc = counted(lambda: fac.marching_cubes(st))
    one_soup = sp_mod.sparse_marching_cubes_soup(ref, TSDF_GRID)
    tri = triangle_set(soup[0].gather(), soup[1].gather()[::3])
    soup_eq = np.array_equal(tri, triangle_set(one_soup.vertices, one_soup.mask))
    m_int = measure(lambda: fac.integrate(st0, depth, intr, eye), profile=False)
    log(f"  integrate: {n} blocks, per shard {counts.tolist()} (sum {int(counts.sum())}); union "
        f"of the shards' keys equal to the single-device sparse_integrate's {keys_eq}, tsdf max "
        f"|diff| {t_err:.3e}, weight {w_err:.3e} (tol 1e-6); the first call {fmt(n_int)}; "
        f"steady state {m_int['ms']:.2f} ms median of 3, {m_int['host_syncs']} host syncs")
    log(f"  extract_surface: {int(surf[1].gather().sum())} points, the single-device multiset "
        f"(5 decimals) {surf_eq}; {fmt(n_surf)}")
    log(f"  marching_cubes: {len(tri)} triangles, the single-device multiset {soup_eq}; "
        f"{fmt(n_mc)}")
    check(keys_eq and int(counts.sum()) == n and t_err <= 1e-6 and w_err <= 1e-6,
          "the slab TSDF's blocks differ from the single-device fusion")
    check(surf_eq and soup_eq and len(tri) > 10000,
          "the slab TSDF's surface or mesh differs from the single-device one")
    ray = dict(near=RAY_NEAR, far=RAY_FAR)
    ray_mod.reset_counts()
    (rd, rv, rn, rm, rc), n_ray = counted(lambda: fac.raycast(st, intr, eye, h, w, **ray))
    march = dict(ray_mod.counts)
    one_ray = tt.sparse_tsdf_raycast(ref, intr, eye, h, w, grid_blocks=TSDF_GRID, **ray)
    n_one = counted(lambda: tt.sparse_tsdf_raycast(ref, intr, eye, h, w, grid_blocks=TSDF_GRID,
                                                   **ray))[1]
    mask_off = (rm != one_ray.mask).float().mean().item()
    both = rm & one_ray.mask
    err = (rd - one_ray.depth).abs()
    sure = both & rc & one_ray.confident
    d_err = err[sure].max().item()
    over = (both & (err > TSDF_VOXEL)).float().sum().item() / both.float().sum().item()
    dots = (rn * one_ray.normals)[both].sum(-1).abs().median().item()
    log(f"  raycast {h}x{w}: hits {rm.float().mean().item():.5f}, mask disagreement with the "
        f"single-device sparse_raycast {mask_off:.5f} (need < 0.01), depth max |diff| "
        f"{d_err:.3e} m on pixels both call confident (need <= a voxel, {TSDF_VOXEL}), "
        f"{over:.5f} of the hits beyond a voxel (need <= {SLAB_RAY_OVER}: JAX's sharded raycast "
        f"0.0015026 on this frame), all hits {err[both].max().item():.3e} m, median normal "
        f"dot {dots:.6f} (need > 0.999); march steps and exit tests over the {SHARDS} shards "
        f"{march}; {fmt(n_ray)}; the single-device call {fmt(n_one)}")
    check(mask_off < 0.01 and d_err <= TSDF_VOXEL and over <= SLAB_RAY_OVER and dots > 0.999,
          "the sharded raycast disagrees with the single-device one")
    report["phase55"] = {"integrate": n_int, "integrate_steady": m_int, "blocks": n,
                         "shard_blocks": counts.tolist(),
                         "extract_surface": n_surf, "marching_cubes": n_mc,
                         "raycast": {**n_ray, "march": march, "mask_disagreement": mask_off,
                                     "depth_err_m": d_err, "over_voxel": over,
                                     "normal_dot_median": dots},
                         "raycast_single_device": n_one}
    del st0, st, ref, surf, one, soup, one_soup, rd, rv, rn, rm, rc, one_ray
    log(f"  phase {phase_seconds()}")

    # -- phase 56 --------------------------------------------------------------
    log(f"phase 56: ShardedFrameToModelOdometry() defaults over {F2M_FRAMES} {h}x{w} wall "
        f"frames (phase 31's), against FrameToModelOdometry() on the same frames")
    frames = [(torch.from_numpy(dpt).to(dev), truth) for dpt, truth in wall_frames()]
    intr_c = tt.CameraIntrinsics(*DEPTH_INTR.tolist())
    odo = tp.ShardedFrameToModelOdometry(mesh, intr_c, h, w)
    one = tt.FrameToModelOdometry(intr_c, h, w, device=dev)
    frame_ms, errs, diffs = [], [], []
    torch.cuda.reset_peak_memory_stats()
    for dpt, truth in frames:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pose = run_counted(kernels, total, lambda: odo.register_frame(dpt))[0]
        torch.cuda.synchronize()
        frame_ms.append(1e3 * (time.perf_counter() - t0))
        pose = pose.cpu().numpy()
        errs.append(pose_errors(pose, truth))
        diffs.append(float(np.abs(pose - one.register_frame(dpt).matrix.cpu().numpy()).max()))
    peak = torch.cuda.max_memory_allocated() / 2**30
    # one more frame, profiled and sync-counted, on a shallow copy: a frame
    # replaces the state and the pose rather than writing into them
    _, n_frame = counted(lambda: copy.copy(odo).register_frame(frames[-1][0]))
    worst = (max(e[0] for e in errs), max(e[1] for e in errs))
    log(f"  pose errors (m, rad) {errs} (worst {worst}, tol {F2M_TOL}); max |pose - the "
        f"single-device pose| {[round(x, 7) for x in diffs]}; ms a frame "
        f"{[round(x, 1) for x in frame_ms]} (after the first: mean {np.mean(frame_ms[1:]):.1f}); "
        f"blocks a shard {odo.state.n_blocks.gather().cpu().tolist()}; peak {peak:.3f} GiB; a "
        f"profiled frame {fmt(n_frame)}")
    check(worst[0] <= F2M_TOL[0] and worst[1] <= F2M_TOL[1],
          "the sharded odometry's poses are off the truth")
    report["phase56"] = {"frame_ms": frame_ms, "ms_per_frame_after_first":
                         float(np.mean(frame_ms[1:])), "pose_errors": errs,
                         "single_device_diff": diffs, "peak_gib": peak, "frame": n_frame}
    del frames, odo, one
    log(f"  phase {phase_seconds()}")

    # -- phase 57 --------------------------------------------------------------
    log("phase 57: the sharded NDT, ground, clusters, SHOT / USC, plane RANSAC, MLS and "
        "colorize against the single-device entries")
    ph57 = {}
    npts = torch.from_numpy(scan(NDT_POINTS, 7)).to(dev)
    ntgt = npts + torch.from_numpy(SHIFT).to(dev)
    nm = torch.ones(NDT_POINTS, dtype=torch.bool, device=dev)
    cfg = dict(NDT_CONFIG, subsample=1)
    ndt_fn = tp.make_sharded_ndt(mesh, **cfg)
    (t_s, score, its, conv), n_ndt = counted(lambda: ndt_fn(npts, nm, ntgt, nm, torch.eye(4)))
    one = ndt_mod.ndt_registration(tt.PointCloud.from_points(npts), tt.PointCloud.from_points(ntgt),
                                   tt.NdtConfig(**cfg))
    t_s, t_1 = t_s.cpu().numpy(), one.transformation.cpu().numpy()
    d_t = float(np.abs(t_s[:3, 3] - t_1[:3, 3]).max())
    d_r = pose_errors(t_s, t_1.astype(np.float64))[1]
    log(f"  NDT at {NDT_POINTS:,} ({cfg}): translation {t_s[:3, 3].tolist()}, {d_t:.3e} m and "
        f"{d_r:.3e} rad off ndt_registration's (tol 1e-3); {int(its)} iterations (single "
        f"device {one.iterations}), score {float(score):.2f} ({float(one.score):.2f}); "
        f"{fmt(n_ndt)}")
    check(d_t <= 1e-3 and d_r <= 1e-3, "the sharded NDT disagrees with ndt_registration")
    ph57["ndt"] = {**n_ndt, "translation_diff_m": d_t, "rotation_diff_rad": d_r}
    del npts, ntgt, nm

    gpts, labels = ground_scan()
    gp = torch.from_numpy(gpts).to(dev)
    gm = torch.ones(len(gpts), dtype=torch.bool, device=dev)
    ground_fn = tp.make_sharded_ground(mesh)
    (g, g_ok, g_nrm), n_gr = counted(lambda: ground_fn(gp, gm))
    one = tt.patchwork_plus_plus(tt.PointCloud.from_points(gp))
    g = g.gather()
    agree = (g == one.ground_mask).float().mean().item()
    both = g_ok & one.patch_valid
    cos = (g_nrm * one.patch_normals)[both].sum(-1).abs().median().item()
    rec, prec = recall_precision(g.cpu().numpy(), labels)
    log(f"  ground on the {len(gpts):,}-point scan: mask agreement with patchwork_plus_plus "
        f"{agree:.6f} (need >= 0.99), median patch-normal cosine {cos:.7f} on "
        f"{int(both.sum())} patches (need > 0.999); recall {rec:.4f} / precision {prec:.4f}; "
        f"{fmt(n_gr)}")
    check(agree >= 0.99 and cos > 0.999, "the sharded ground disagrees with patchwork_plus_plus")
    ph57["ground"] = {**n_gr, "agreement": agree, "normal_cos_median": cos}
    del gp, gm, g, one

    street, source = street_scene()
    boxes = street[source >= 0]
    cpts = torch.from_numpy(boxes[np.random.default_rng(SLAB_SEED).choice(
        len(boxes), N_RING, replace=False)]).to(dev)
    cm = torch.ones(N_RING, dtype=torch.bool, device=dev)
    ccfg = tt.EuclideanClusterConfig(tolerance=STREET_TOLERANCE,
                                     min_cluster_size=STREET_MIN_CLUSTER)
    cl_fn = tp.make_sharded_clusters(mesh, ccfg)
    (lab, n_cl, sizes), n_clu = counted(lambda: cl_fn(cpts, cm))
    one = tt.extract_euclidean_clusters(tt.PointCloud.from_points(cpts), ccfg)
    lab_eq = (lab.gather() == one.labels).float().mean().item()
    sizes_eq = torch.equal(sizes, one.sizes)
    log(f"  clusters on {N_RING:,} of the street's box samples (tolerance {STREET_TOLERANCE}): "
        f"{int(n_cl)} clusters (single device {int(one.n_clusters)}), labels equal on "
        f"{lab_eq:.6f}, sizes equal {sizes_eq}; {fmt(n_clu)}")
    check(int(n_cl) == int(one.n_clusters) == STREET_BOXES and lab_eq >= 0.999 and sizes_eq,
          "the sharded clusters disagree with extract_euclidean_clusters")
    ph57["clusters"] = {**n_clu, "clusters": int(n_cl), "labels_equal": lab_eq}
    del street, source, boxes, cpts, cm, lab, one

    rp = torch.from_numpy(scan(N_RING, 0)).to(dev)
    rmask = torch.ones(N_RING, dtype=torch.bool, device=dev)
    cloud = tt.ops.normals.estimate_normals(tt.PointCloud.from_points(rp), K_NORMALS)
    for variant in ("shot", "usc"):
        scfg = tt.ShotConfig(method="exact")
        sh_fn = tp.make_sharded_shot(mesh, scfg, variant=variant)
        (desc, valid), n_sh = counted(lambda: sh_fn(rp, rmask, cloud.normals))
        one = (tt.extract_shot_features(cloud, scfg) if variant == "shot"
               else tt.extract_usc_features(cloud, scfg))
        desc, valid = desc.gather(), valid.gather()
        v_eq = torch.equal(valid, one.valid)
        cos = (desc * one.descriptors)[one.valid].sum(-1)
        med = cos.median().item()
        log(f"  {variant} ({scfg.radius} m, {scfg.max_neighbors} neighbours) on {N_RING:,} "
            f"points of scan: valid {int(valid.sum())}, equal to the staged path's {v_eq}; "
            f"median cosine {med:.7f} (need > 0.99999), >= 0.99 on "
            f"{(cos >= 0.99).float().mean().item():.5f}; {fmt(n_sh)}")
        check(v_eq and med > 0.99999, f"the sharded {variant} disagrees with the staged path")
        ph57[variant] = {**n_sh, "cos_median": med}
        del desc, valid, one

    mls_cfg = tt.MlsConfig(search_radius=SLAB_MLS_RADIUS)
    mls_fn = tp.make_sharded_mls(mesh, mls_cfg)
    (proj, _, mvalid), n_mls = counted(lambda: mls_fn(rp, rmask))
    one = tt.mls_smooth(tt.PointCloud.from_points(rp), mls_cfg)
    close = ((proj.gather() - one.points).abs().amax(1) < 1e-4).float().mean().item()
    log(f"  MLS (radius {SLAB_MLS_RADIUS} m, {mls_cfg.max_neighbors} neighbours) on {N_RING:,} "
        f"points of scan: valid {int(mvalid.gather().sum())}, projections within 1e-4 of "
        f"mls_smooth's on {close:.5f} (need >= 0.98); {fmt(n_mls)}")
    check(close >= 0.98, "the sharded MLS disagrees with mls_smooth")
    ph57["mls"] = {**n_mls, "close_share": close}
    del rp, rmask, cloud, proj, one

    big = torch.from_numpy(scan(N_SLAB_BIG, 0)).to(dev)
    bm = torch.ones(N_SLAB_BIG, dtype=torch.bool, device=dev)
    pl_fn = tp.make_sharded_plane_ransac(mesh, STREET_PLANE_TOL, STREET_RANSAC)
    pl, n_pl = counted(lambda: pl_fn(big, bm))
    one = tt.ops.segmentation.segment_plane(tt.PointCloud.from_points(big), STREET_PLANE_TOL,
                                           STREET_RANSAC)
    pcos = abs(float(pl.model.normal @ one.model.normal))
    inl = (pl.inlier_mask.gather() == one.inlier_mask).float().mean().item()
    log(f"  plane RANSAC ({STREET_PLANE_TOL} m, {STREET_RANSAC} hypotheses) on {N_SLAB_BIG:,} "
        f"points of scan: plane cosine with segment_plane's {pcos:.8f} (need > 0.9999), offsets "
        f"{float(pl.model.d):.5f} / {float(one.model.d):.5f}, inliers {int(pl.inlier_count):,} "
        f"/ {int(one.inlier_count):,}, masks equal on {inl:.6f} (need >= 0.999); {fmt(n_pl)}")
    check(pcos > 0.9999 and inl >= 0.999, "the sharded plane RANSAC disagrees with segment_plane")
    ph57["plane_ransac"] = {**n_pl, "cos": pcos, "mask_agreement": inl}
    del pl, one

    rng = np.random.default_rng(COLOR_SEED)
    views = street_cameras()
    imgs = torch.from_numpy(rng.uniform(0, 1, (COLOR_VIEWS,) + COLOR_HW + (3,))
                            .astype(np.float32)).to(dev)
    intrs = torch.tensor([COLOR_INTR] * COLOR_VIEWS, dtype=torch.float32, device=dev)
    w2cs = torch.from_numpy(np.stack(views)).to(dev)
    col_fn = tp.make_sharded_colorize(mesh, *COLOR_HW, bilinear=True)
    (colors, assigned), n_col = counted(lambda: col_fn(big, bm, imgs, intrs, w2cs))
    rgb_views = [RgbImageView(imgs[i], tt.CameraIntrinsics(*COLOR_INTR), w2cs[i])
                 for i in range(COLOR_VIEWS)]
    one = tt.colorize_from_images(tt.PointCloud.from_points(big), rgb_views,
                                  mode=tt.InterpolationMode.BILINEAR)
    colors, assigned = colors.gather(), assigned.gather()
    col_eq = torch.equal(colors[assigned], one.colors[assigned])
    log(f"  colorize {N_SLAB_BIG:,} points of scan from {COLOR_VIEWS} {COLOR_HW} views "
        f"(bilinear): {int(assigned.sum()):,} assigned, colours bit-equal to "
        f"colorize_from_images' {col_eq}, the rest 0 {not colors[~assigned].any().item()}; "
        f"{fmt(n_col)}")
    check(col_eq and not colors[~assigned].any().item() and int(assigned.sum()) > 0,
          "the sharded colorize differs from colorize_from_images")
    ph57["colorize"] = {**n_col, "assigned": int(assigned.sum())}
    report["phase57"] = ph57
    del big, bm, imgs, w2cs, colors, assigned, one
    log(f"  ({report['card']}, SM clock {sm_clock()})")
    log(f"  phase {phase_seconds()}")

    # -- phase 58 --------------------------------------------------------------
    log(f"phase 58: make_sharded_mg_solver at {POISSON_RES}^3 (8 V-cycles) on phase 35's "
        f"right-hand side, make_sharded_poisson(PoissonConfig(depth=7)) on its {POISSON_N:,} "
        f"points")
    pts_np = scan(POISSON_N, 3)
    pts_np = pts_np / np.maximum(np.linalg.norm(pts_np, axis=1, keepdims=True), 1e-9)
    pts = torch.from_numpy(pts_np).to(dev)
    pmask = torch.ones(POISSON_N, dtype=torch.bool, device=dev)
    spacing = torch.tensor(2.4 / (POISSON_RES - 1), device=dev)
    origin = torch.full((3,), POISSON_LO, device=dev)
    rhs = poisson_mod._splat(pts, pts, pmask, origin, spacing, POISSON_RES)[0]
    mg_fn = tp.make_sharded_mg_solver(mesh, POISSON_RES, cycles=8)
    x_s, n_mg = counted(lambda: mg_fn(rhs, 1e-4))
    x_1, n_mg1 = counted(lambda: multigrid.mg_solve(rhs, torch.tensor(1e-4, device=dev),
                                                    cycles=8))
    x_s = x_s.gather()
    scale = x_1.abs().max().item()
    mg_err = (x_s - x_1).abs().max().item()
    log(f"  mg solver: max |x - mg_solve's x| {mg_err:.3e} of max|x| {scale:.4f} "
        f"({mg_err / scale:.3e}; tol 1e-6), bit-equal on {(x_s == x_1).float().mean().item():.6f} "
        f"of the voxels; sharded {fmt(n_mg)}; single device {fmt(n_mg1)}")
    check(mg_err <= 1e-6 * scale, "the x-slab multigrid disagrees with mg_solve")
    fields_fn = tp.make_sharded_poisson_fields(mesh, POISSON_RES, cycles=8)
    (chi, iso, _), n_fields = counted(lambda: fields_fn(pts, pts, pmask, origin, spacing))
    chi_1, iso_1, _ = poisson_mod._solve(pts, pts, pmask, origin, spacing, POISSON_RES, 200, 1e-4,
                                         solver="multigrid", mg_cycles=8)
    cscale = chi_1.abs().max().item()
    chi_err = (chi - chi_1).abs().max().item() / cscale
    iso_err = abs(float(iso) - float(iso_1)) / cscale
    cloud = tt.PointCloud.from_numpy(pts_np, normals=pts_np, device=dev)
    run = tp.make_sharded_poisson(mesh, tt.PoissonConfig(depth=7))
    pmesh, n_pr = counted(lambda: run(cloud))
    v, f = pmesh.to_numpy()
    r = np.linalg.norm(v, axis=1)
    log(f"  fields: chi within {chi_err:.3e} of max|chi| of _solve's (tol {POISSON_CHI_TOL}), iso "
        f"{iso_err:.3e}; {fmt(n_fields)}")
    log(f"  make_sharded_poisson: {len(v)} vertices, {len(f)} faces, radius median "
        f"{np.median(r):.5f}, std {r.std():.5f} (tol {POISSON_RADIUS_TOL}); {fmt(n_pr)}")
    check(chi_err <= POISSON_CHI_TOL and iso_err <= POISSON_CHI_TOL,
          "the sharded Poisson fields disagree with _solve")
    check(len(f) > 10000 and abs(np.median(r) - 1.0) <= POISSON_RADIUS_TOL
          and r.std() < POISSON_RADIUS_TOL, "the sharded Poisson mesh is off the sphere")
    report["phase58"] = {"mg_solver": {**n_mg, "max_diff": mg_err, "scale": scale},
                         "mg_solve_single_device": n_mg1,
                         "fields": {**n_fields, "chi_err": chi_err, "iso_err": iso_err},
                         "poisson": {**n_pr, "faces": len(f), "radius_median": float(np.median(r)),
                                     "radius_std": float(r.std())}}
    log(f"  ({report['card']}, SM clock {sm_clock()})")
    log(f"  phase {phase_seconds()}")
    check(not any(total.values()), "phases 55-58 launched a kernel")
    return total, report


if __name__ == "__main__":
    sys.exit(main())
