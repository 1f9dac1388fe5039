"""Deployable artifacts: ``export.py`` writes a program with
``torch.export`` and the ``.meta`` contract of the JAX package's
exporter. The other exporters and the native driver are ``ROADMAP.md``
A13.9."""
