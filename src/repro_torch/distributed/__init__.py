"""Distributed layer of the port: device meshes (``mesh.py``), the
sharding rules and leaves laid out on a mesh (``sharding.py``), the
sequence-parallel decode (``collectives.py``), elastic restarts
(``elastic.py``) and the fault-tolerant training loop (``ft.py``); the
counterparts of ``repro.distributed`` and ``repro.launch.mesh``."""
