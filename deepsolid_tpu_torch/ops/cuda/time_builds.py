"""Times the two ways of building the port's kernels on a CUDA machine.

    python -m deepsolid_tpu_torch.ops.cuda.time_builds

1. The route build.py takes: one nvcc per source in csrc/, started
   together, each a shared library with a plain C interface for ctypes.
2. The torch.utils.cpp_extension route: a binding file that includes
   torch/extension.h and checks each launch with
   C10_CUDA_KERNEL_LAUNCH_CHECK, compiled by cpp_extension.load (needs
   ninja). Only the binding is compiled here: it is what that route adds
   on top of the same nvcc compiles.

Both build from scratch into `_build/timing/` (beside build.py's
libraries, gitignored). Prints one JSON line.
"""

from __future__ import annotations

import json
import shutil
import time

from deepsolid_tpu_torch.ops.cuda import build

BINDING = r"""
#include <torch/extension.h>
#include <c10/cuda/CUDAException.h>

// The per-launch check the extension route puts after every kernel launch.
void launch_check() { C10_CUDA_KERNEL_LAUNCH_CHECK(); }

PYBIND11_MODULE(TORCH_EXTENSION_NAME, m) {
  m.def("launch_check", &launch_check);
}
"""


def main() -> None:
    import torch
    from torch.utils import cpp_extension

    root = build.BUILD_DIR / "timing"
    shutil.rmtree(root, ignore_errors=True)
    ctypes_dir, ext_dir = root / "ctypes", root / "extension"
    ext_dir.mkdir(parents=True)

    build.BUILD_DIR = ctypes_dir
    ctypes_s, _ = build.build()

    result = {"ctypes_nvcc_seconds": ctypes_s, "sources": list(build.SOURCES),
              "ninja": cpp_extension.is_ninja_available(),
              "torch": torch.__version__, "cuda": torch.version.cuda}
    if result["ninja"]:
        src = ext_dir / "binding.cpp"
        src.write_text(BINDING)
        start = time.perf_counter()
        mod = cpp_extension.load(name="timing_binding", sources=[str(src)],
                                 build_directory=str(ext_dir), with_cuda=True,
                                 verbose=False)
        result["extension_binding_seconds"] = time.perf_counter() - start
        mod.launch_check()
    else:
        result["extension_binding_seconds"] = None  # cpp_extension.load needs ninja
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
