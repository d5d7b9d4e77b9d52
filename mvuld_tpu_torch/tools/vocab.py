"""Fixed label vocabularies of the graph modality (data-format contract).

``NODE_TYPE_MAP`` and ``EDGE_TYPE_MAP`` are the canonical node/edge label
vocabularies the models consume (reference: mvuld/data/data_list.py:29-36
type_map / 456-463 etype_map). They are part of the on-disk feature format, so
the ids must match for checkpoint compatibility.

``SENSITIVE_APIS`` plays the role of the reference's ~800-entry ``l_funcs``
list (mvuld/sastvd/helpers/joern.py:670+): calls to these well-known
memory/string/IO/concurrency C functions are bucketed as "Builtin Function
Call" instead of "External Function Call". This is our own curated list of the
standard dangerous/libc/win32 APIs; it is a classification heuristic, not a
learned artifact, so coverage differences only shift rare node-type labels.
"""

NODE_TYPE_MAP = {
    "UNKNOWN": 0, "METHOD": 1, "METHOD_PARAMETER_IN": 2, "BLOCK": 3,
    "External Function Call": 4, "Comparison Operator": 5, "IDENTIFIER": 6,
    "Assignment Operator": 7, "RETURN": 8, "LITERAL": 9, "METHOD_RETURN": 10,
    "METHOD_PARAMETER_OUT": 11, "IF": 12, "Arithmetic Operator": 13,
    "Builtin Function Call": 14, "Access Operator": 15, "FIELD_IDENTIFIER": 16,
    "Other Operator": 17, "LOCAL": 18, "Logical Operator": 19,
    "Cast Operator": 20, "WHILE": 21, "ELSE": 22, "FOR": 23, "GOTO": 24,
    "JUMP_TARGET": 25, "SWITCH": 26, "BREAK": 27, "DO": 28, "CONTINUE": 29,
    "TYPE_DECL": 30, "MEMBER": 31,
}

NUM_NODE_TYPES = len(NODE_TYPE_MAP)

EDGE_TYPE_MAP = {
    "AST": 0, "CDG": 1, "REACHING_DEF": 2, "CFG": 3, "EVAL_TYPE": 4, "REF": 5,
}

NUM_EDGE_TYPES = len(EDGE_TYPE_MAP)

# graph-type → admitted edge labels (reference: sastvd/helpers/joern.py rdg:455-489)
GRAPH_TYPE_EDGES = {
    "ast": {"AST"},
    "cfg": {"CFG"},
    "cdg": {"CDG"},
    "pdg": {"REACHING_DEF", "CDG"},
    "cfgcdg": {"CFG", "CDG"},
    "all": {"CFG", "CDG", "AST"},
    "other": {"CFG", "CDG", "REACHING_DEF"},
}

SENSITIVE_APIS = frozenset("""
strcpy strncpy strcat strncat strlen strcmp strncmp strchr strrchr strstr strtok
strdup strndup stpcpy strlcpy strlcat strerror strspn strcspn strpbrk strcoll
sprintf snprintf vsprintf vsnprintf printf fprintf vprintf vfprintf
scanf sscanf fscanf vscanf vsscanf vfscanf
gets fgets puts fputs getc fgetc getchar putchar fputc ungetc
memcpy memmove memset memcmp memchr bcopy bzero bcmp
malloc calloc realloc free alloca valloc posix_memalign aligned_alloc
open close read write lseek creat unlink access stat fstat lstat
fopen fclose fread fwrite fseek ftell rewind fflush feof ferror fileno
freopen tmpfile tmpnam mktemp mkstemp remove rename
dup dup2 pipe fork execl execlp execle execv execvp execve system popen pclose
exit abort atexit _exit raise signal kill alarm
atoi atol atoll atof strtol strtoul strtoll strtoull strtod strtof
rand srand random srandom drand48 lrand48
getenv setenv putenv unsetenv
time ctime gmtime localtime mktime strftime asctime difftime clock gettimeofday
socket bind listen accept connect send recv sendto recvfrom setsockopt getsockopt
shutdown select poll epoll_wait inet_ntoa inet_addr inet_pton inet_ntop
gethostbyname getaddrinfo freeaddrinfo htons htonl ntohs ntohl
pthread_create pthread_join pthread_exit pthread_detach pthread_cancel
pthread_mutex_init pthread_mutex_lock pthread_mutex_unlock pthread_mutex_destroy
pthread_cond_init pthread_cond_wait pthread_cond_signal pthread_cond_broadcast
sem_init sem_wait sem_post sem_destroy
mmap munmap mprotect msync madvise brk sbrk
chmod chown umask getuid geteuid getgid getegid setuid setgid getpid getppid
opendir readdir closedir rewinddir mkdir rmdir chdir getcwd realpath basename dirname
isalpha isdigit isalnum isspace isupper islower toupper tolower isxdigit ispunct
abs labs llabs div ldiv fabs ceil floor sqrt pow exp log log10 sin cos tan
setjmp longjmp sigsetjmp siglongjmp
wcscpy wcsncpy wcscat wcsncat wcslen wcscmp wcsncmp swprintf vswprintf
_memccpy _mbscpy _mbsncpy _mbscat _mbsncat _mbslen _mbscmp
lstrcpy lstrcpyn lstrcat lstrcatn lstrlen lstrcmp lstrcmpi
CopyMemory MoveMemory FillMemory ZeroMemory SecureZeroMemory
StrCpy StrCpyN StrCat StrCatN StrNCat StrNCpy StrLen StrDup
wsprintf wvsprintf wnsprintf _snprintf _vsnprintf _snwprintf _vsnwprintf
CreateFile ReadFile WriteFile CloseHandle DeleteFile MoveFile CopyFile
CreateProcess WinExec ShellExecute LoadLibrary GetProcAddress FreeLibrary
HeapAlloc HeapFree HeapReAlloc LocalAlloc LocalFree GlobalAlloc GlobalFree
VirtualAlloc VirtualFree VirtualProtect
RegOpenKey RegQueryValue RegSetValue RegCloseKey
MultiByteToWideChar WideCharToMultiByte CharToOem OemToChar
recv_from sendmsg recvmsg readv writev pread pwrite
syslog openlog closelog err errx warn warnx perror
crypt getpass getlogin cuserid ttyname
_ui64toa _ui64tow _i64toa _i64tow _itoa _itow _ultoa _ultow ultoa
qsort bsearch assert
""".split())
