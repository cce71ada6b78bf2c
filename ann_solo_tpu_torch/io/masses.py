"""Physical mass constants the port needs (Da), the values of
`ann_solo_tpu/io/masses.py`."""

PROTON = 1.00727646677
NEUTRON = 1.00335483507  # C13 - C12 isotope spacing
