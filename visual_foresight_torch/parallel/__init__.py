"""Running the port over several devices: the one-process mesh
(``mesh.py``) and the flagship's sharded replan (``flagship_check.py``)."""
