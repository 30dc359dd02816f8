"""The launch layer of the port: H100 production meshes on the meta device,
each cell's input stand-ins, a per-device cost counter over the cell's real
program, and the dry run of every (arch x shape) cell
(``python -m repro_torch.launch.dryrun``)."""
