"""PyTorch port: the CUDA build helper keys a library by its source and
every header beside it, so an edited header rebuilds (no nvcc needed)."""
import pytest

pytest.importorskip("torch")

from repro_torch.kernels import _build  # noqa: E402


def test_library_path_follows_source_and_headers(tmp_path):
    src = tmp_path / "kernel.cu"
    src.write_text('#include "common.cuh"\nint f() { return 1; }\n')
    header = tmp_path / "common.cuh"
    header.write_text("#pragma once\n")
    first = _build.library_path(src)
    assert first.parent == _build.BUILD_DIR
    assert first.name.startswith("kernel_") and first.suffix == ".so"
    assert _build.library_path(src) == first            # unchanged: reused

    header.write_text("#pragma once\n// edited\n")
    edited = _build.library_path(src)
    assert edited != first                              # header edit: rebuild

    header.write_text("#pragma once\n")
    assert _build.library_path(src) == first            # edit undone

    (tmp_path / "more.cuh").write_text("#pragma once\n")
    assert _build.library_path(src) not in (first, edited)   # a new header

    src.write_text('#include "common.cuh"\nint f() { return 2; }\n')
    assert _build.library_path(src) not in (first, edited)   # source edit


def test_flash_attention_build_is_keyed_by_its_ptx_header(tmp_path):
    # a copy of csrc/: editing its sm90.cuh moves flash_attention.cu's
    # library, as an edit of the header in the repository would
    for f in _build.CSRC.iterdir():
        if f.suffix in (".cu", ".cuh"):
            (tmp_path / f.name).write_bytes(f.read_bytes())
    src = tmp_path / "flash_attention.cu"
    assert '#include "sm90.cuh"' in src.read_text()
    before = _build.library_path(src)
    assert before == _build.library_path(_build.CSRC / src.name)
    header = tmp_path / "sm90.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    assert _build.library_path(src) != before
