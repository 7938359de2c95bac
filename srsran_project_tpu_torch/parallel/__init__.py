"""The multi-chip layer on torch.distributed: meshes, halo exchange,
subcarrier- and codeblock-sharded PUSCH decode, codeblock-sharded PDSCH
encode, and the host-aware mesh (port of ``srsran_project_tpu/parallel``)."""
