from .model import Haplotag, AnRead, AnAllele, spanning_tag_value
from .breakpoints import ParseMsg, get_breakpoints, parse_alignment
from .extract import parse_anreads, parse_analleles, parse_anallele
from .kmer import KmerEncoding, Kusage, seq2kcounts
