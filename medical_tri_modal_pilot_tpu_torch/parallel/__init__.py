"""Several processes on one model: process-group start-up
(``distributed``), the (data, model) mesh and the tensor-parallel layout
(``mesh``), and a launcher for N ranks on one host (``launch``)."""
