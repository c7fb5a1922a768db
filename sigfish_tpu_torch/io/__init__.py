from .blow5 import Slow5File, Slow5Record
from .fasta import read_fasta
