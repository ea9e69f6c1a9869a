"""zkDL core protocols of the port: the same modules and names as
`repro.core`, on int64 word tensors."""
