"""The yardstick's arithmetic: the proof geometry of a cell
(`geometry`), the chip's peaks (`peaks`) and the operations and bytes
the protocol and each kernel need (`counts`).  Worked out from the
cell's widths, batch and window alone; nothing here imports the
program."""
