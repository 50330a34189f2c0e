from .bed import BED, parse_bed_file
