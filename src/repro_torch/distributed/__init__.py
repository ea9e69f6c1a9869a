"""Mesh code of the port: sharding rules and ambient sharding hints on
`torch.distributed` DeviceMesh and DTensor."""
