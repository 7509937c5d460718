"""AIS 6-bit character set used by Mode-S ident fields (ais_charset.c)."""

AIS_CHARSET = "@ABCDEFGHIJKLMNOPQRSTUVWXYZ[\\]^_ !\"#$%&'()*+,-./0123456789:;<=>?"


def is_valid_callsign_char(c: str) -> bool:
    return ("A" <= c <= "Z") or ("-" <= c <= "9") or c == " " or c == "@"
