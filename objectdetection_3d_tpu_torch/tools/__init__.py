"""Offline command-line tools of the port, run with ``python -m``:
``tools.prepare_data`` (raw cloud -> training ``.npy``) and
``tools.build_gt_database`` (the ObjectSample GT database)."""
