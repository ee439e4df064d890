"""Row-band multi-device frontend of the port (parallel/mesh.py,
parallel/frontend.py)."""
