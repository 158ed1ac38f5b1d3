"""The host link's published rate, against which the memo's copies are
read (``perfbench/metrics/memo_link_share.train.py``)."""

#: PCIe Gen5 x16, one direction: 32 GT/s × 16 lanes with 128b/130b
#: encoding, 63 GB/s of data, rounded as the data sheets state it.
PCIE_GEN5_X16_BYTES_PER_S = 64e9
