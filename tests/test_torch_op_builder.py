"""The port's kernel builder on the CPU (no ``nvcc`` needed): the library
name of a kernel hashes its source and every shared ``csrc/*.cuh`` header,
so an edit to either never loads a stale library."""

import shutil

import pytest

from deepspeed_tpu_torch.ops.op_builder import builder

TILE_USERS = ("flash_attention", "paged_attention")


@pytest.fixture
def package_copy(tmp_path, monkeypatch):
    """The builder pointed at a copy of the package's kernel sources."""
    root = tmp_path / "deepspeed_tpu_torch"
    shutil.copytree(builder.PACKAGE_ROOT / "csrc", root / "csrc")
    monkeypatch.setattr(builder, "PACKAGE_ROOT", root)
    monkeypatch.setattr(builder, "BUILD_DIR", root / "build")
    return root


def _names():
    return {name: builder.so_path(name).name for name in builder.KERNEL_SOURCES}


def test_so_path_depends_on_content_only(package_copy, monkeypatch):
    copied = _names()
    monkeypatch.undo()
    assert _names() == copied


def test_header_edit_changes_so_path_of_its_users(package_copy):
    header = package_copy / "csrc" / "mma_tile.cuh"
    assert header.exists()
    for name in TILE_USERS:
        assert "mma_tile.cuh" in (package_copy / builder.KERNEL_SOURCES[name]).read_text()
    before = _names()
    header.write_text(header.read_text() + "\n// edited\n")
    after = _names()
    for name in TILE_USERS:
        assert after[name] != before[name], name
    assert all(after[n].startswith(f"{n}_") and after[n].endswith(".so") for n in after)


def test_new_header_changes_so_path(package_copy):
    before = _names()
    (package_copy / "csrc" / "extra.cuh").write_text("#pragma once\n")
    assert all(after != before[n] for n, after in _names().items())


def test_source_edit_changes_only_its_own_so_path(package_copy):
    before = _names()
    source = package_copy / builder.KERNEL_SOURCES["flash_attention"]
    source.write_text(source.read_text() + "\n// edited\n")
    after = _names()
    assert after["flash_attention"] != before["flash_attention"]
    assert {n: p for n, p in after.items() if n != "flash_attention"} == \
        {n: p for n, p in before.items() if n != "flash_attention"}


def test_host_library_hashes_its_source_and_flags_only(package_copy):
    """The g++-built aio engine is named by its own source and ``CXX_FLAGS``:
    a kernel header does not rename it, an edit to its source does."""
    name = "ds_aio"
    before = builder.so_path(name).name
    (package_copy / "csrc" / "extra.cuh").write_text("#pragma once\n")
    assert builder.so_path(name).name == before
    source = package_copy / builder.HOST_SOURCES[name]
    source.write_text(source.read_text() + "\n// edited\n")
    after = builder.so_path(name).name
    assert after != before and after.startswith(f"{name}_") and after.endswith(".so")
