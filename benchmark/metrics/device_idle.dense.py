"""Device: the share of a dense step in which the device is idle, in
percent, by ``device_idle.sfm``'s formula: 1 - the union of all device
operations of the profiled step / the mean host time of the unprofiled
steps (``elapsed_s``)."""

from benchmark.run import load_module

read = load_module("metrics", "device_idle.sfm").read
