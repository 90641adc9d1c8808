"""The kernel lab: Hopper counterparts of the JAX package's lab harnesses
(``scripts/kernel_lab.py``, ``scripts/cumprod_lab.py``,
``scripts/segpair_mosaic_probe.py``).

- :mod:`.scene`: the labs' synthetic scene (20000 random Gaussians at
  800x800) binned into the two-level frame the compositors read;
- :mod:`.chunked`: the chunked-scan dense compositor, forward in four
  scan forms and backward, over ``csrc/lab_chunked.cu``;
- :mod:`.probes`: the six lowering probes over ``csrc/lab_probes.cu``,
  each with its plain version and the script's NumPy oracle;
- :mod:`.harness`: the drivers the ``scripts/torch_*_lab.py`` and
  ``scripts/torch_segpair_probe.py`` entry points run.

The lab's kernels are not on the trainer's path: they measure forms of
the production compositor (``ops/raster_v2.py``) on the same frame.
"""
