from .timestamp import antimestamp, log, warn
from .fmt import fmt_double, fmt_float
