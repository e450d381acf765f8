"""STAR in PyTorch: the port of ``repro`` to PyTorch and CUDA on Hopper.

The package mirrors ``repro``'s layout module for module.  It imports
``torch`` and numpy only: never JAX and nothing of ``repro``.  Entry points
(``core.engine.StarEngine``, ``storage.StorageEngine``, ``convert``,
``models.transformer.LM``, ``serve.engine.ServeEngine``,
``launch.serve``, ``train.trainer.Trainer``, ``launch.train``) run on
``cuda`` unless the caller passes
``device="cpu"``; the kernels in
``csrc/`` are built with nvcc at their first launch (``kernels._build``).

Package inits stay empty of imports so that every module can be imported
on its own (the JAX package's ``core/__init__`` import cycle is not
copied); ``service``, ``reads`` and ``changelog`` export their public
classes as the reference's do, and none of them is imported by a module
they import.
"""
