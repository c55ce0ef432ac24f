"""Kinds of run, one module each: ``train`` and ``decode``. A cell file
names its driver; a new kind is a new module with a ``run(ctx)``."""
