"""The kernel build's cache key and nvcc command (CPU only, no nvcc).

``ops/build.py`` names each library after a hash of its source, the shared
headers ``csrc/*.cuh`` and the flags, so an edited header must change the
name (or a stale library would load), and nvcc must find the headers
through ``-I csrc`` when it compiles a copy of a source made elsewhere.
"""

import pytest

from consensus_tpu_torch.ops import build


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    root = tmp_path / "csrc"
    root.mkdir()
    (root / "kernel.cu").write_text('#include "shared.cuh"\n__global__ void k() {}\n')
    (root / "shared.cuh").write_text("// version 1\n")
    monkeypatch.setattr(build, "CSRC_DIR", root)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    return root


def test_unchanged_sources_keep_the_library_path(csrc):
    assert build.library_path("kernel") == build.library_path("kernel")
    assert build.library_path("kernel").parent == build.BUILD_DIR


@pytest.mark.parametrize(
    "edit",
    [
        lambda root: (root / "shared.cuh").write_text("// version 2\n"),
        lambda root: (root / "kernel.cu").write_text("__global__ void k2() {}\n"),
        lambda root: (root / "another.cuh").write_text("// new header\n"),
    ],
    ids=["header-edited", "source-edited", "header-added"],
)
def test_an_edit_changes_the_library_path(csrc, edit):
    before = build.library_path("kernel")
    edit(csrc)
    assert build.library_path("kernel") != before


def test_other_files_do_not_change_the_library_path(csrc):
    before = build.library_path("kernel")
    (csrc / "notes.txt").write_text("not a source\n")
    assert build.library_path("kernel") == before


def test_include_flag_points_at_csrc(csrc, tmp_path):
    copy = tmp_path / "_build" / "mutant" / "kernel_copy.cu"
    args = build.nvcc_args(copy, copy.with_suffix(".so"))
    i = args.index("-I")
    assert args[i + 1] == str(csrc)
    assert args[-1] == str(copy) and args[args.index("-o") + 1] == str(copy.with_suffix(".so"))
    assert "arch=compute_90a,code=sm_90a" in args


def test_both_kernels_include_the_shared_header():
    assert (build.CSRC_DIR / "sm90_mma.cuh") in set(build.CSRC_DIR.glob("*.cuh"))
    for name in ("flash_attention", "decode_attention"):
        source = (build.CSRC_DIR / f"{name}.cu").read_text()
        assert '#include "sm90_mma.cuh"' in source


def test_flash_attention_includes_the_wgmma_header_and_hashes_it(tmp_path, monkeypatch):
    """K1 includes ``sm90_wgmma.cuh`` (its wgmma, TMA and mbarrier PTX), so
    an edit of that header renames K1's library."""
    source = (build.CSRC_DIR / "flash_attention.cu").read_text()
    assert '#include "sm90_wgmma.cuh"' in source
    root = tmp_path / "csrc"
    root.mkdir()
    for path in build.CSRC_DIR.iterdir():
        if path.suffix in (".cu", ".cuh"):
            (root / path.name).write_bytes(path.read_bytes())
    monkeypatch.setattr(build, "CSRC_DIR", root)
    before = build.library_path("flash_attention")
    header = root / "sm90_wgmma.cuh"
    header.write_text(header.read_text() + "// edited\n")
    assert build.library_path("flash_attention") != before


def test_flash_attention_runs_on_wgmma_and_tma_only():
    """K1's kernel multiplies with wgmma (both products) and copies with
    TMA under mbarriers; none of the mma.sync, ldmatrix or cp.async helpers
    of ``sm90_mma.cuh`` is called from it."""
    source = (build.CSRC_DIR / "flash_attention.cu").read_text()
    for call in ("wgmma_ss_m64n", "wgmma_rs_m64n", "tma_load_4d(", "tma_store_4d(",
                 "mbar_wait(", "setmaxnreg_dec<", "setmaxnreg_inc<"):
        assert call in source, call
    for call in ("mma_bf16(", "ldmatrix", "cp_async", "load_rows<", "mma.sync"):
        assert call not in source, call
    header = (build.CSRC_DIR / "sm90_wgmma.cuh").read_text()
    for ptx in ("wgmma.mma_async", "cp.async.bulk.tensor.4d", "mbarrier.try_wait.parity",
                "setmaxnreg"):
        assert ptx in header, ptx


def test_decode_attention_includes_the_wgmma_header_and_hashes_it(tmp_path, monkeypatch):
    """K2 includes ``sm90_wgmma.cuh`` (its mbarrier, TMA and cluster PTX),
    so an edit of that header renames K2's library."""
    source = (build.CSRC_DIR / "decode_attention.cu").read_text()
    assert '#include "sm90_wgmma.cuh"' in source
    root = tmp_path / "csrc"
    root.mkdir()
    for path in build.CSRC_DIR.iterdir():
        if path.suffix in (".cu", ".cuh"):
            (root / path.name).write_bytes(path.read_bytes())
    monkeypatch.setattr(build, "CSRC_DIR", root)
    before = build.library_path("decode_attention")
    header = root / "sm90_wgmma.cuh"
    header.write_text(header.read_text() + "// edited\n")
    assert build.library_path("decode_attention") != before


def test_decode_attention_loads_by_tma_and_merges_in_a_cluster():
    """K2 fills its ring by TMA under mbarriers and merges its key splits
    through another block's shared memory behind a cluster barrier,
    launched with a cluster dimension; the PTX it calls is in the header."""
    source = (build.CSRC_DIR / "decode_attention.cu").read_text()
    for call in ("tma_load_4d(", "mbar_expect_tx(", "mbar_wait(", "mbar_arrive(",
                 "mbar_arrive_cp_async(", "cluster_arrive_relaxed(", "cluster_wait(",
                 "cluster_sync(", "cluster_map(", "st_cluster_f4(",
                 "cudaLaunchKernelEx(", "cudaLaunchAttributeClusterDimension",
                 "cudaOccupancyMaxActiveClusters("):
        assert call in source, call
    header = (build.CSRC_DIR / "sm90_wgmma.cuh").read_text()
    for ptx in ("cp.async.bulk.tensor.4d", "mbarrier.try_wait.parity",
                "cp.async.mbarrier.arrive.noinc", "barrier.cluster.arrive.release",
                "barrier.cluster.wait.acquire", "mapa.shared::cluster", "st.shared::cluster",
                "%cluster_ctarank"):
        assert ptx in header, ptx


def test_decode_attention_is_one_kernel_without_scratch():
    """One kernel a call: no second (combine) kernel in K2's source, and no
    device scratch allocated by its launch wrapper."""
    import inspect

    from consensus_tpu_torch.ops import decode_attention as da

    source = (build.CSRC_DIR / "decode_attention.cu").read_text()
    assert "decode_combine_kernel" not in source
    assert source.count("__global__") == 1
    launch = inspect.getsource(da.launch_kernel)
    assert "torch.empty" not in launch and "torch.zeros" not in launch
