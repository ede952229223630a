"""The kernel builder's cache key (``aki_torch.ops.cuda_build.library_path``):
a library is named by a hash of its source, every shared header of the
source directory and the nvcc flags, so an edit to any of them is never
served from a stale build. No nvcc and no card: only paths are compared."""

import pytest

from aki_torch.ops import cuda_build


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    """A source directory of two kernels and one shared header."""
    (tmp_path / "one.cu").write_text('#include "shared.cuh"\nint one;\n')
    (tmp_path / "two.cu").write_text('#include "shared.cuh"\nint two;\n')
    (tmp_path / "shared.cuh").write_text("#pragma once\nconstexpr int kTile = 64;\n")
    monkeypatch.setattr(cuda_build, "CSRC", tmp_path)
    return tmp_path


@pytest.mark.parametrize("edited", ["one.cu", "shared.cuh"])
def test_library_path_follows_source_and_headers(csrc, edited):
    before = {n: cuda_build.library_path(n) for n in ("one", "two")}
    assert before == {n: cuda_build.library_path(n) for n in ("one", "two")}   # stable
    assert before["one"] != before["two"]
    path = csrc / edited
    path.write_bytes(path.read_bytes().replace(b"64", b"128").replace(b"one;", b"one = 1;"))
    after = {n: cuda_build.library_path(n) for n in ("one", "two")}
    assert after["one"] != before["one"]
    # a header change reaches every kernel; a kernel's own source only itself
    assert (after["two"] != before["two"]) == edited.endswith(".cuh")


def test_new_header_changes_path(csrc):
    before = cuda_build.library_path("one")
    (csrc / "more.cuh").write_text("#pragma once\n")
    assert cuda_build.library_path("one") != before


def test_real_sources_share_the_hopper_header():
    """The flash kernels include the shared header that the hash covers."""
    for name in ("flash_mma_fwd", "flash_mma_bwd"):
        assert '#include "hopper.cuh"' in (cuda_build.CSRC / f"{name}.cu").read_text()
    assert (cuda_build.CSRC / "hopper.cuh").exists()


def test_every_included_header_is_hashed():
    """Each header a real source includes from the source directory (the
    flash kernels' hopper.cuh, the int8 serving kernels' cp_async.cuh) is
    one of the shared headers that library_path hashes."""
    import re

    hashed = {p.name for p in cuda_build.CSRC.glob("*.cuh")}
    included = {}
    for src in cuda_build.CSRC.glob("*.cu"):
        for name in re.findall(r'#include "([^"]+)"', src.read_text()):
            included.setdefault(name, []).append(src.stem)
    assert set(included) <= hashed
    assert sorted(included["cp_async.cuh"]) == ["decode_attention", "fused_quant"]
