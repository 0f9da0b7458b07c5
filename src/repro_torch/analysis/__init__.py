"""Measurement tools of the port: the calibration sweep (``calibrate.py``)
that writes the cost model's measured artifact for a device, and the
roofline accounting on the H100 data sheet (``roofline.py``)."""
