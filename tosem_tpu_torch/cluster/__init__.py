"""The cluster fabric, as far as the port has it: the chunked tensor
transport (``cluster/transport.py``) and the epoch fences
(``cluster/fencing.py``), copies of the JAX package's modules of the
same names. Nodes, supervisors, gangs and the RPC plane come with
cluster serving (ROADMAP.md A11).

Import-light: nothing here loads torch until a tensor is sent or
received.
"""
