"""Measurement tools of the port: the calibration sweep (``calibrate.py``)
that writes the cost model's measured artifact for a device."""
