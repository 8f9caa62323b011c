"""Launchers: training (``train``) and serving (``serve``), with the
meshes and input specs they share."""
