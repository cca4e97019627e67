"""Roofline of the port (port of ``repro.roofline``): the kernels' work
counts (:mod:`.costs`), the traced cost of a step (:mod:`.trace`), the
three-term roofline on the H100's peaks (:mod:`.analysis`) and the report
over the dry-run's records (:mod:`.report`)."""
