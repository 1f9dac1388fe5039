"""Benchmark utilities of the port: the study's result-CSV schema
(``results``), device timing (``timing``) and the H100's roofline
(``roofline``). Submodules import lazily; nothing here touches a card."""
