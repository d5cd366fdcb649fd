"""Several devices and several processes: the pixel plane in bands.

`sharding.py` splits the plane into contiguous pixel bands, one per device
of a mesh (a list of torch devices; one card may take several bands), runs
each band through the ported kernels and merges the bands' events into the
reference order. `multihost.py` gives each process of a torch.distributed
job its band of rows and merges the processes' event parts.
"""
