"""Multi-device execution: the mesh and its tensor-parallel layouts
(``mesh.py``, uce_tpu/parallel/mesh.py's names) and the ranks' processes
(``workers.py``)."""
