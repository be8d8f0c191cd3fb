from .builder import BUILD_DIR, KERNEL_SOURCES, AsyncIOBuilder, build_kernel, find_nvcc, load_kernel, so_path

__all__ = ["BUILD_DIR", "KERNEL_SOURCES", "AsyncIOBuilder", "build_kernel", "find_nvcc", "load_kernel", "so_path"]
