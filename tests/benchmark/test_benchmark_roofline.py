"""The roofline floors: published peaks, and work that no implementation
choice (grid walk, clusters, squarings) moves."""

import benchmark_cpu  # noqa: F401  (puts the repository on sys.path)
import pytest

from benchmark import roofline


def test_the_peaks_are_the_published_h100_sxm_figures():
    assert roofline.PEAK_FLOPS == 67e12
    assert roofline.PEAK_BYTES_PER_S == 3.35e12
    assert roofline.floor_seconds(67e12, 0) == (1.0, "operations")
    assert roofline.floor_seconds(0, 3.35e12) == (1.0, "bytes")


def test_sphere_floor_reads_segments_hits_and_the_sky_only():
    ops = roofline.OPS
    segments, pixels, spp = 1000, 100, 2
    hits = segments - pixels * spp
    got, nbytes = roofline.sphere_frame(segments, pixels, spp, n_spheres=487)
    assert got == (segments * (ops["ray"] + ops["segment"])
                   + hits * (ops["sphere_test"] + ops["sphere_hit"])
                   + (segments - hits) * ops["miss"])
    # a grid, a BVH or brute force: the sphere count enters only the bytes read
    assert roofline.sphere_frame(segments, pixels, spp, n_spheres=6402)[0] == got
    assert nbytes == pixels * 12 + 487 * 36
    assert roofline.sphere_frame(segments, pixels, spp, 487, sky="black")[0] < got


def test_tape_floor_takes_every_leaf_per_hit_and_no_cluster():
    ops = roofline.OPS
    per_leaf = ops["leaf_transform"] + ops["sphere_interval"] + 2 * ops["candidate_test"]
    one, _ = roofline.tape_frame(300, 100, 1, n_leaves=1)
    eight, _ = roofline.tape_frame(300, 100, 1, n_leaves=8)
    assert eight - one == 200 * 7 * per_leaf  # 200 hits; misses read no leaf
    assert roofline.tape_frame(100, 100, 1, n_leaves=8)[0] == 100 * (ops["segment"] + ops["miss"])


def test_atrous_floor_squares_five_times_whatever_the_program_does():
    assert roofline.NORMAL_SQUARINGS == 5  # sigma_n = 32
    ops = roofline.OPS
    none, nbytes = roofline.atrous_frame(100, 2, [0, 0])
    both, _ = roofline.atrous_frame(100, 2, [10, 20])
    assert both - none == 30 * (ops["atrous_both_hit"] + 5)
    per_pass = ops["atrous_centre"] + 25 * ops["atrous_tap"]
    assert none == 100 * ops["atrous_pixel"] + 2 * 100 * per_pass
    assert nbytes == 100 * 53


def test_gbuffer_floor_is_bytes_bound_at_720p():
    ops, nbytes = roofline.gbuffer_frame(1280 * 720, 900_000, 487)
    assert roofline.floor_seconds(ops, nbytes)[1] == "bytes"
    assert nbytes == 1280 * 720 * 29 + 487 * 36


@pytest.mark.parametrize("floor,kernel,want", [(1.0, 2.0, 50.0), (0.5, 0.5, 100.0)])
def test_share_is_floor_over_kernel_time(floor, kernel, want):
    assert roofline.share_percent(floor, kernel) == pytest.approx(want)


def test_share_without_kernel_time_is_no_number():
    assert roofline.share_percent(1.0, 0.0) is None
