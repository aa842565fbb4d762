"""The port's host library in C++: the PixelLink decode's union-find and
per-component geometry (``pixellink_cc.cpp``) and the AP/IoBB sweep
(``eval_sweep.cpp``), built with g++ at first use (``build.load``)."""

from gssd_torch.native.build import NATIVE, compiler_version, load  # noqa: F401
