"""Build driver: pure-Python package plus the optional native _hostio
extension (C, CPython API). The extension is best-effort — environments
without a toolchain still get the full framework with numpy fallbacks
(see nbodyhpc_jax/runtime/__init__.py)."""
import numpy as np
from setuptools import Extension, setup
from setuptools.command.build_ext import build_ext


class OptionalBuildExt(build_ext):
    def run(self):
        try:
            super().run()
        except Exception as e:  # pragma: no cover
            print(f"warning: native _hostio build failed ({e}); "
                  "falling back to pure-Python host IO")

    def build_extension(self, ext):
        try:
            super().build_extension(ext)
        except Exception as e:  # pragma: no cover
            print(f"warning: building {ext.name} failed ({e})")


setup(
    ext_modules=[
        Extension(
            "nbodyhpc_jax._hostio",
            sources=["csrc/hostio.c"],
            include_dirs=[np.get_include()],
            extra_compile_args=["-O3", "-march=native", "-pthread"],
            extra_link_args=["-pthread"],
        )
    ],
    cmdclass={"build_ext": OptionalBuildExt},
)
