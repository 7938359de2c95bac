"""FAPI messages and their validators (port of ``srsran_project_tpu/fapi``)."""
