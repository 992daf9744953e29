"""Compute ops: projection and z-buffer, splatting, TSDF integrate."""
