"""Build hook: ship the C++ runtime sources inside the wheel.

The native libraries (``native/*.cpp`` — isosurface marching tetrahedra,
point-cloud grid ops) are compiled on first use by
``d3fields_tpu/native_build.py``, so the wheel only needs the *sources*.
They live at the repo root (outside the package) for the checkout
layout; this hook copies them into ``<build_lib>/d3fields_tpu/_native_src/``
and ``<build_lib>/d3fields_tpu_torch/_native_src/`` (the PyTorch port's
``native_build.py`` reads them there) during ``build_py`` — the build tree
only, never the source checkout — so they land in the wheel.
``MANIFEST.in`` carries them into sdists so sdist-built wheels get them
too. ``native_build.load_native`` searches
the checkout location first, then the packaged copy, and falls back to a
user cache dir for the compiled ``.so`` when the install is read-only.
"""

import os
import shutil

from setuptools import setup
from setuptools.command.build_py import build_py


class BuildPyWithNativeSources(build_py):
    def run(self):
        super().run()
        root = os.path.dirname(os.path.abspath(__file__))
        native = os.path.join(root, "native")
        if not os.path.isdir(native):
            return
        for pkg in ("d3fields_tpu", "d3fields_tpu_torch"):
            dst = os.path.join(self.build_lib, pkg, "_native_src")
            os.makedirs(dst, exist_ok=True)
            for name in sorted(os.listdir(native)):
                if name.endswith(".cpp"):
                    shutil.copy2(os.path.join(native, name),
                                 os.path.join(dst, name))


setup(cmdclass={"build_py": BuildPyWithNativeSources})
